"""Multi-device execution over ``torch.distributed``: scanline- and
sample-sharded rendering and the sharded training step.

Port of ``mcray_tpu/parallel/shard.py``. A mesh is a ``DeviceMesh`` with the
reference's axis names, one device per rank: NCCL on GPUs, gloo on the CPU.
Where the reference runs one ``shard_map`` program, every rank here runs the
same Python code on its own shard:

- **Scanlines** (axis ``"rays"``): each rank traces its R / n elements (x S
  paths) against the replicated scene and marches them into its own R / n
  RF columns: a scanline's echoes land only in its column (reference
  add_echo, src/rfimage.h:33-40), so the march needs no communication.
- **Samples** (axis ``"samples"``, the 2-D mesh): each rank traces S / m of
  an element's paths; the partial RF images of a sample group are summed.
- **Image assembly**: with ``distributed_imaging`` the PSF convolution runs
  on the column shards with a halo from the next ranks
  (``imaging.convolve_psf_sharded``), the envelope column by column, and
  one ``all_gather`` assembles the enveloped image; otherwise the raw
  image is gathered and the fused postproc (K3) runs on it. Log compression
  and the scan conversion (K4) run replicated on the gathered image.
- **Gradients**: the backward of each rank's local work gives a partial of
  the (M, 8) material gradient; the train step sums them with one
  ``all_reduce``, the ``psum`` that ``shard_map``'s AD inserts.

The draws of each path are keyed by its global path id (``path_draws``), so
a sharded frame draws exactly the single-device frame's randoms, and each
rank draws only for its own paths. Every rank holds a ``Simulator`` for the
replicated state (scene, materials, texture seeds, scan maps) and its
closest-hit policy: the listed cluster kernel on 128-triangle clusters at
2,048 triangles and up, as the single device runs it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import SimConfig
from ..models.simulator import (Simulator, march_segments, path_draws, scan_convert_frame,
                                trace_paths)
from ..models.trainer import _adam
from ..ops import imaging
from ..ops.collectives import gather_blocks, sum_blocks
from ..ops.cuda.postproc import postproc_cuda
from ..probe.transducer import element_layout
from ..utils import rng


def backend_for(device) -> str:
    """The collectives' backend for ``device``'s type: NCCL for ``cuda``
    (raising where there is no card or no NCCL: never gloo instead), gloo
    for ``cpu``."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device and none is available; pass "
                               'device="cpu" for a gloo mesh on the CPU')
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda mesh needs NCCL, and this torch has none (it does not "
                               "fall back to gloo)")
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no mesh on device type {kind!r}; expected 'cuda' or 'cpu'")


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device) -> DeviceMesh:
    """A mesh of ``shape`` over the whole world, one device per rank. Where
    no process group exists and the mesh has one device, a one-rank group
    starts on a free local port (JAX's single-process mesh); a process group
    of another backend, or a size the world does not hold, raises."""
    backend = backend_for(device)
    size = 1
    for n in shape:
        size *= n
    if not dist.is_initialized():
        if size != 1:
            raise ValueError(f"a mesh of {size} devices needs a process group of {size} ranks: "
                             "start one with multihost.initialize or torchrun")
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    elif backend not in dist.get_backend():
        raise RuntimeError(f"the process group runs {dist.get_backend()!r}; a "
                           f"{torch.device(device).type} mesh needs {backend!r}")
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"a mesh of {size} devices over {world} ranks: each rank holds one "
                         "device, so the mesh spans the world")
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, axis: str = "rays", *, device="cuda") -> DeviceMesh:
    """1-D mesh over the world's ranks (all of them; ``n_devices`` must
    equal the world size where given)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh((n_devices,), (axis,), device)


def make_mesh_2d(n_rays: int, n_samples: int, *, device="cuda") -> DeviceMesh:
    """2-D mesh: scanlines x Monte-Carlo samples (``"rays"``, ``"samples"``);
    ``mesh.get_group("samples")`` is the sample axis' group."""
    return _mesh((n_rays, n_samples), ("rays", "samples"), device)


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class _ShardedBase:
    """The layout and the frame of a sharded renderer: elements over
    ``axis_r``, and the samples over ``axis_s`` where given."""

    def __init__(self, pack, cfg: SimConfig, mesh: DeviceMesh, axis_r: str, axis_s: str | None,
                 seed: int, distributed_imaging: bool):
        n_r = mesh.size(mesh.mesh_dim_names.index(axis_r))
        n_s = 1 if axis_s is None else mesh.size(mesh.mesh_dim_names.index(axis_s))
        if cfg.transducer_elements % n_r or cfg.samples_per_element % n_s:
            raise ValueError(
                f"transducer_elements ({cfg.transducer_elements}) and samples_per_element "
                f"({cfg.samples_per_element}) must divide evenly over the mesh ({n_r} x {n_s})")
        if distributed_imaging:
            imaging.require_uncentered_psf(cfg, "the halo imaging (distributed_imaging=True)")
        self.cfg, self.pack, self.mesh = cfg, pack, mesh
        self.distributed_imaging = distributed_imaging
        self.group = mesh.get_group(axis_r)
        self.sample_group = None if axis_s is None else mesh.get_group(axis_s)
        self.sim = Simulator(pack, cfg, device=_mesh_device(mesh), seed=seed)
        self.device = self.sim.device
        self.materials = self.sim.materials

        s = cfg.samples_per_element
        s_local = s // n_s
        self.r_local = cfg.transducer_elements // n_r
        self.r0 = mesh.get_local_rank(axis_r) * self.r_local
        my_s = 0 if axis_s is None else mesh.get_local_rank(axis_s)
        local = torch.arange(self.r_local, dtype=torch.int64, device=self.device)
        sample = torch.arange(s_local, dtype=torch.int64, device=self.device)
        # global path id = global element * S + (my_s * S_local + local sample)
        self.path_ids = ((self.r0 + local[:, None]) * s + my_s * s_local
                         + sample[None, :]).reshape(-1)
        self.local_elem = local.int().repeat_interleave(s_local)

    def _frame(self, trace_key, materials, position, angles):
        """(bmode, this rank's RF columns) of the frame keyed ``trace_key``."""
        sim, cfg = self.sim, self.cfg
        materials = sim._tensor(materials, sim.materials)
        position = sim._tensor(position, sim.position)
        angles = sim._tensor(angles, sim.angles)
        draws = path_draws(trace_key, cfg, self.device, self.path_ids)
        positions, directions = element_layout(position, angles, cfg)
        mine = slice(self.r0, self.r0 + self.r_local)
        segments = trace_paths(draws, materials, position, angles, sim.scene, sim.spacing,
                               sim.starting_material, cfg,
                               elements=(positions[mine], directions[mine], self.local_elem),
                               **sim.trace_kw)
        _, rf_local = march_segments(segments, materials, sim.seeds, sim.volume, cfg, self.r_local)
        if self.sample_group is not None:
            rf_local = sum_blocks(rf_local, self.sample_group)
        if self.distributed_imaging:
            rf_conv = imaging.convolve_psf_sharded(rf_local, cfg, self.group)
            rf_env = gather_blocks(imaging.apply_envelope(rf_conv, cfg), self.group, dim=1)
        else:
            rf_env = postproc_cuda(gather_blocks(rf_local, self.group, dim=1), cfg)
        _, bmode = scan_convert_frame(rf_env, sim.scan_maps, cfg)
        return bmode, rf_local

    def render_bmode(self, key, materials=None, position=None, angles=None) -> torch.Tensor:
        """The B-mode of the frame whose trace key is ``key`` (a (2,) key of
        ``utils/rng.py``), replicated on every rank; differentiable in
        ``materials``. As the reference's ``render_bmode``, the key is used
        as given: ``render_frame(seed)`` is ``render_bmode(fold_in(
        prng_key(seed), 0))``."""
        return self._frame(key, materials, position, angles)[0]

    def render_frame(self, seed: int = 0, materials=None, position=None, angles=None) -> dict:
        """The frame of ``seed`` (the single device's ``render_frame(seed)``):
        ``bmode`` replicated, ``rf_raw`` this rank's RF columns (after the
        sum over its sample group, on the 2-D mesh)."""
        key = rng.fold_in(rng.prng_key(seed), 0)
        bmode, rf_local = self._frame(key, materials, position, angles)
        return {"bmode": bmode, "rf_raw": rf_local}


class ShardedRenderer(_ShardedBase):
    """Scanline-sharded renderer over a 1-D mesh (default ``make_mesh()``, on
    the card). ``distributed_imaging`` picks the halo imaging (True, the
    reference's default) or the gathered image through K3 (False)."""

    def __init__(self, pack, cfg: SimConfig, mesh: DeviceMesh | None = None, seed: int = 0,
                 distributed_imaging: bool = True):
        mesh = make_mesh() if mesh is None else mesh
        super().__init__(pack, cfg, mesh, mesh.mesh_dim_names[0], None, seed, distributed_imaging)

    def make_train_step(self, learning_rate: float, mask=None,
                        materials=None) -> "ShardedTrainStep":
        """A sharded Adam step on the material table (``ShardedTrainStep``),
        from ``materials`` (default the scene's)."""
        return ShardedTrainStep(self, learning_rate, mask, materials)


class ShardedRenderer2D(_ShardedBase):
    """Renderer over a ``("rays", "samples")`` mesh (``make_mesh_2d``):
    elements over ``rays`` (their own RF columns), Monte-Carlo samples over
    ``samples`` (a sum of partial RF images); the halo imaging on ``rays``."""

    def __init__(self, pack, cfg: SimConfig, mesh: DeviceMesh, seed: int = 0):
        super().__init__(pack, cfg, mesh, "rays", "samples", seed, True)


class ShardedTrainStep:
    """One sharded training step a call: render the B-mode sharded, pixel
    MSE against the target, backward (each rank's local work gives a partial
    of the material gradient), the partials summed by ``all_reduce`` over
    the mesh, the mask applied, then ``torch.optim.Adam`` at
    ``learning_rate`` as ``MaterialFitter`` builds it. Port of
    ``mcray_tpu/parallel/shard.py:407-432``, which takes an optax optimiser:
    the port takes the rate, as its ``MaterialFitter`` does. The step holds
    the parameters (``materials``) and the optimiser; ``last_grad`` is the
    masked, summed gradient of the latest step."""

    def __init__(self, renderer: ShardedRenderer, learning_rate: float, mask=None,
                 materials=None):
        self.renderer = renderer
        device = renderer.device
        init = renderer.materials if materials is None else materials
        self.materials = torch.as_tensor(init, dtype=torch.float32, device=device).detach().clone()
        self.materials.requires_grad_(True)
        self.mask = None if mask is None else torch.as_tensor(mask, dtype=torch.float32,
                                                              device=device)
        self.optimizer = _adam([self.materials], learning_rate)
        self.last_grad = None

    def __call__(self, key, target, position=None, angles=None) -> float:
        """One step on the frame whose trace key is ``key`` (as
        ``render_bmode`` takes it); returns the loss before the update."""
        self.optimizer.zero_grad(set_to_none=True)
        bmode = self.renderer.render_bmode(key, self.materials, position, angles)
        loss = torch.mean((bmode - torch.as_tensor(target, device=bmode.device)) ** 2)
        loss.backward()
        grad = self.materials.grad
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=self.renderer.group)
        if self.mask is not None:
            grad.mul_(self.mask)
        self.last_grad = grad.detach().clone()
        self.optimizer.step()
        return float(loss.detach())
