"""The floors of the fit's backward kernels on one NVIDIA H100, frozen with the
benchmark beside ``roofline.py`` (its peaks and its rule: the larger of the
bytes over 3.35 TB/s and the operations over 67 TFLOP/s of f32).

They are counted on the configuration's shapes, whatever computes the
function: a kernel of the program, a library, the reference.

- The march's backward (K8) of ``frames`` frames: the packed segments read
  (``SOA_FIELDS`` f32 fields of every segment, samples x bounces a column,
  the columns padded to a multiple of ``TILE_C``) and their gradient
  written, the RF cotangent read. Its operations (the march steps that land
  in the window, each a scatterer lookup and its partials) depend on the
  traced segments, which a reader of the device view does not see: the
  floor counts the bytes.
- The scan conversion's backward (K9) of ``frames`` frames: the B-mode
  cotangents and the two f32 coordinate maps read, the RF gradients
  written; a multiply and an add a tap (four taps a pixel at most, far
  below the bytes' time).
"""

from __future__ import annotations

from .roofline import PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S, SOA_FIELDS, TILE_C

#: the cell whose configuration the shares are counted on (the metrics list it alone)
FIT_CELL = "sphere_soft.fit"


def rf_rows(p: dict) -> int:
    axial_um = int(1.45 / p["transducer_frequency"] * 1000.0)
    window_us = int(p["ultrasound_depth_cm"] * 1e4 / p["speed_of_sound"])
    return (int(p["speed_of_sound"]) * window_us) // axial_um


def floor_ms(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S) * 1e3


def march_bwd_floor_ms(p: dict, frames: int) -> float:
    cols = frames * p["transducer_elements"]
    c_pad = cols + (-cols) % TILE_C
    soa = 4 * p["samples_per_element"] * p["max_depth"] * SOA_FIELDS * c_pad
    return floor_ms(2 * soa + 4 * rf_rows(p) * cols, 0)


def scanconv_bwd_floor_ms(p: dict, frames: int) -> float:
    n_rf = rf_rows(p) * p["transducer_elements"]
    n_bm = p["bmode_rows"] * p["bmode_cols"]
    return floor_ms(4 * frames * n_bm + 2 * 4 * n_bm + 4 * frames * n_rf, 2 * 4 * frames * n_bm)


def share(trace, kernel: str, floor) -> float | None:
    """A kernel's roofline share, %: its floor a launch (``floor(p,
    frames)``, the launch's frames being the traced frames over its
    launches) over its device ms a launch in the view. ``p`` is the
    acquisition of the configuration of the cells that report the metric."""
    launches = sum(n for name, n in trace.view["count_by_name"].items() if kernel in name)
    ms = trace.kernel_ms(kernel)
    if not launches or ms <= 0:
        return None
    return 100.0 * floor(acquisition(), trace.frames // launches) / (ms / launches)


def acquisition() -> dict:
    """The acquisition of the fit cell's configuration."""
    from . import cell

    return cell.config(cell.workload(cell.benchmark(), FIT_CELL)["config"])["acquisition"]
