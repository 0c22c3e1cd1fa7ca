"""Seconds of set-up in the program's scene compile: its longest
``scene.compile`` span (``scene/compile.py:load_and_compile``: meshes,
parse, BVH build)."""

from benchmark.harness import stages


def read(trace):
    got = stages.records()
    return None if got is None else stages.longest_s(got[0], "scene.compile")
