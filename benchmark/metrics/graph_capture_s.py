"""Seconds of set-up in the chained batch's warm-up step and graph capture:
the program's longest ``chained.capture`` span."""

from benchmark.harness import stages


def read(trace):
    got = stages.records()
    return None if got is None else stages.longest_s(got[0], "chained.capture")
