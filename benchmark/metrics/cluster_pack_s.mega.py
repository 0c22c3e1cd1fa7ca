"""Seconds of set-up in the program's cluster packing of the mega scene: its
longest ``simulator.clusters`` span (``Simulator.__init__``:
``clusters.pack_tris_culled``, 4,832 clusters of 128 triangles, sorted
nearest-first to the probe, and their upload). None where the program
records no such span."""

from benchmark.harness import stages


def read(trace):
    got = stages.records()
    return None if got is None else stages.longest_s(got[0], "simulator.clusters")
