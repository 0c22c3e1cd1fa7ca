"""Nodes of the fit step's CUDA graph a frame: the program's counters
``fit.graph_nodes`` over ``fit.graph_frames``, both counted once at capture
(the nodes from the graph under capture)."""

from benchmark.harness import stages


def read(trace):
    got = stages.records()
    frames = 0 if got is None else got[1].get("fit.graph_frames", 0)
    return got[1]["fit.graph_nodes"] / frames if frames else None
