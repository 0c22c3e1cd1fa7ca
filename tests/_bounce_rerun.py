"""The yardstick of the bounce physics' backward (``ops/cuda/bounce.py``):
autograd over the plain version of a launch, rerun on the launch's inputs.
No backward takes it; ``tests/test_torch_bounce.py``,
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the backward kernel
and its plain twin to it.

The rerun gathers the table's rows from a double copy of it
(``physics.take_rows`` gives the same f32 rows), so autograd sums the
table's gradient in double. Random gradients on a row's far end reach ~1e9
in a path's terms (a path in a medium of attenuation ~0 reaches ~1e9
away), and an f32 sum of 20,480 of them moves by up to ~6e-5 with its
order (the card's atomics pick one).

Plain torch: it imports neither JAX nor the reference package.
"""

from __future__ import annotations

import torch

from mcray_tpu_torch.ops.cuda.bounce import GRADED_ROW


def rerun_grads(run, inputs, needs, grads) -> list:
    """Autograd over ``run``, the plain version of a launch, rerun on leaves
    of its ``inputs`` (those of ``needs`` requiring grad), with the
    gradients ``grads`` of its outputs (None: zero): the gradient of each
    input that needs one, None for the rest."""
    leaves = [t.detach().requires_grad_(need) if need else t.detach()
              for t, need in zip(inputs, needs)]
    with torch.enable_grad():
        outs = run(*leaves)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
    wanted = [t for t in leaves if t.requires_grad]
    if not pairs or not wanted:
        return [None] * len(inputs)
    got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                   allow_unused=True))
    return [next(got) if t.requires_grad else None for t in leaves]


def rerun_start(record):
    """Row 0's launch of ``record`` (a ``bounce._Record``) as its plain
    version, for ``rerun_grads``: (positions, directions, materials,
    spacing) -> its ``GRADED_ROW`` fields."""
    def run(positions, directions, materials, spacing):
        row = record.start_plain(positions, directions, materials.double(), spacing)
        return tuple(row[k] for k in GRADED_ROW)
    return run


def rerun_bounce(record, d: int, ints: dict, hit, mesh_id):
    """Bounce ``d``'s launch of ``record`` as its plain version, for
    ``rerun_grads``: (row d's ``GRADED_ROW`` fields, point, normal,
    materials, spacing) -> segment d's ``to`` and ``reflected``, then row
    d + 1's ``GRADED_ROW`` fields."""
    def run(*inputs):
        *graded, point, normal, materials, spacing = inputs
        row = {**dict(zip(GRADED_ROW, graded)), **ints}
        hits = {"hit": hit, "point": point, "normal": normal, "mesh_id": mesh_id}
        to, reflected, nxt = record.bounce_plain(d, row, hits, materials.double(), spacing)
        return (to, reflected, *(nxt[k] for k in GRADED_ROW))
    return run


def rerun_bounce_grads(record, d: int, row: dict, hits: dict, materials, spacing, grads: dict,
                       needs) -> dict:
    """``rerun_grads`` over ``rerun_bounce`` with the gradients ``grads`` as
    ``_Record.bounce_backward`` takes them and ``needs`` for the inputs (row
    d's ``GRADED_ROW`` fields, point, normal, materials, spacing): the
    gradients by name."""
    run = rerun_bounce(record, d, {k: row[k] for k in ("media_id", "outside", "valid")},
                       hits["hit"], hits["mesh_id"])
    inputs = [*(row[k] for k in GRADED_ROW), hits["point"], hits["normal"], materials, spacing]
    outs = [grads["to"], grads["reflected"], *(grads["next"][k] for k in GRADED_ROW)]
    names = (*GRADED_ROW, "point", "normal", "materials", "spacing")
    return dict(zip(names, rerun_grads(run, inputs, needs, outs)))
