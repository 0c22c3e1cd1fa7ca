"""Seconds of set-up in the fit step's warm-up step and graph capture: the
program's longest ``fit.capture`` span."""

from benchmark.harness import stages


def read(trace):
    got = stages.records()
    return None if got is None else stages.longest_s(got[0], "fit.capture")
