"""Multi-process meshes and the scaling report.

Counterpart of gpufhe_tpu/parallel/multihost.py, over torch.distributed:

* the **coeff** axis (two all_to_alls per NTT, latency-sensitive) stays
  within a process, over its local devices;
* the **limb** axis (one exact modular allreduce per key switch) takes the
  processes: mesh.FheMesh's allreduce over it goes through
  torch.distributed.all_gather, then add_mod in rank order.

A single-process run is the degenerate case of the same code path.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpufhe_tpu_torch.parallel.mesh import FheMesh


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Bring up torch.distributed (a no-op for one process): NCCL where the
    process has a card, gloo on the CPU. coordinator: "host:port" of rank 0."""
    import torch.distributed as dist

    if num_processes is None or num_processes <= 1:
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def global_fhe_mesh(limb_hosts: int | None = None, *, devices=None) -> FheMesh:
    """('limb', 'coeff') mesh over ALL processes: the limb axis spans the
    processes, the coeff axis stays within one. `devices` are this
    process's local devices (default: every CUDA device it sees; raises
    where it sees none); each process holds len(devices) / coeff rows. With
    limb_hosts=None the limb axis equals the process count."""
    import torch.distributed as dist

    multi = dist.is_available() and dist.is_initialized()
    n_proc = dist.get_world_size() if multi else 1
    rank = dist.get_rank() if multi else 0
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("global_fhe_mesh: no CUDA device; name the local devices")
        devices = [f"cuda:{i}" for i in range(count)]
    per_host = len(devices)
    limb = limb_hosts if limb_hosts is not None else n_proc
    total = n_proc * per_host
    if limb % n_proc or total % limb:
        raise ValueError(f"{limb} limb rows do not divide over {n_proc} processes of "
                         f"{per_host} devices")
    rows_here = limb // n_proc
    coeff = total // limb
    rows = range(rank * rows_here, (rank + 1) * rows_here)
    return FheMesh(limb, coeff, devices, rows=rows, distributed=multi)


def _random_ct(params, level, rng):
    """A random NTT-domain ciphertext pair int64[level, N] (canonical)."""
    q = np.asarray(params.q_primes[:level], dtype=np.int64)[:, None]
    return [torch.from_numpy(rng.integers(0, q, size=(level, params.n))) for _ in range(2)]


def _random_key(params, rng, device):
    """A random Montgomery-form relinearisation key (shape donor)."""
    from gpufhe_tpu_torch.keys.keys import DeviceKSKey
    from gpufhe_tpu_torch.primitives.rns import ks_groups

    chain = np.asarray(params.q_primes + params.p_primes, dtype=np.int64)[:, None]
    dnum = len(ks_groups(params, params.num_limbs))
    b, a = (torch.from_numpy(rng.integers(0, chain, size=(dnum, len(chain), params.n)))
            for _ in range(2))
    return DeviceKSKey(b.to(device), a.to(device))


def scaling_report(params, mesh_shapes: list[tuple[int, int]], iters: int = 5,
                   level: int | None = None, mode: str = "strong", *,
                   device: str = "cuda") -> list[dict]:
    """ops/s of the sharded mult step across mesh shapes.

    mode="strong": fixed total work (one mult of fixed N): efficiency is
    speedup / device-ratio. mode="weak": a batch of devices / base_devices
    independent mults per shape, so per-device work is constant: efficiency
    is base_time / time. A shape runs only if its device count is at most
    the number of DISTINCT devices (CUDA devices, or one CPU): logical
    shards on one device are never reported as scaling, so one card gives
    the 1 x 1 row alone."""
    from gpufhe_tpu_torch.parallel import sharded as sh

    assert mode in ("strong", "weak")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("scaling_report: no CUDA device")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    level = level if level is not None else params.num_limbs
    rng = np.random.default_rng(0)
    rlk = _random_key(params, rng, devices[0])
    a0, a1 = _random_ct(params, level, rng)
    b0, b1 = _random_ct(params, level, rng)

    shapes = [s for s in mesh_shapes if s[0] * s[1] <= len(devices)]
    base_ndev = min(s[0] * s[1] for s in shapes) if shapes else 1

    def sync():
        if devices[0].startswith("cuda"):
            torch.cuda.synchronize()

    rows = []
    base = None
    for limb, coeff in shapes:
        ndev = limb * coeff
        batch = max(1, ndev // base_ndev) if mode == "weak" else 1
        mesh = sh.make_fhe_mesh(limb, coeff, devices=devices[:ndev])
        run, prepare = sh.make_sharded_mult(params, level, mesh)
        bundle = prepare(rlk)
        blocks = [sh.shard_ct_component(c, params, mesh) for c in (a0, a1, b0, b1)]
        run(*blocks, bundle)
        sync()
        t0 = time.time()
        for _ in range(iters):
            for _b in range(batch):
                run(*blocks, bundle)
        sync()
        dt = (time.time() - t0) / iters  # per batch of `batch` mults
        ops = batch / dt
        if base is None:
            base = (ndev, ops, dt)
        if mode == "weak":
            eff = 100.0 * base[2] / dt  # flat time = perfect weak scaling
        else:
            eff = 100.0 * (ops / base[1]) / (ndev / base[0])
        rows.append({
            "mode": mode,
            "mesh": f"limb={limb} x coeff={coeff}",
            "devices": ndev,
            "batch": batch,
            "ms_per_mult": round(dt * 1e3 / batch, 3),
            "ops_per_s": round(ops, 2),
            "scaling_eff_pct": round(eff, 1),
        })
    return rows


def weak_scaling_report(params, mesh_shapes, iters: int = 5, level=None, *,
                        device: str = "cuda"):
    """Back-compat alias; see scaling_report (mode='weak')."""
    return scaling_report(params, mesh_shapes, iters=iters, level=level, mode="weak",
                          device=device)
