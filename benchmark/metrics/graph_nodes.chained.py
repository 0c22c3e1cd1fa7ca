"""Nodes of the step's CUDA graph a frame: the program's counters
``chained.graph_nodes`` over ``chained.graph_frames``, both counted once at
capture (the nodes from the graph under capture)."""

from benchmark.harness import stages


def read(trace):
    got = stages.records()
    frames = 0 if got is None else got[1].get("chained.graph_frames", 0)
    return got[1]["chained.graph_nodes"] / frames if frames else None
