"""gpufhe_tpu_torch.parallel.planner against gpufhe_tpu's: the bootstrap's
mesh-program inventory and level schedule at boot_ci_f equal the
reference's, program for program and call count for call count, with the
same output level and scale; lower_program builds each family from a zero
key, and its meta (kind, level, key and plaintext residency per shard)
counts the reference's elements (the port's int64 bytes are twice the
reference's uint32 ones)."""

import dataclasses

import jax
import pytest
import torch

from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu.parallel import planner as rplanner
from gpufhe_tpu.parallel import sharded as rsh
from gpufhe_tpu_torch.parallel import planner
from gpufhe_tpu_torch.parallel import sharded as sh
from gpufhe_tpu_torch.params.params import preset


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's PyTorch CPU work (N = 2^7)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inventory(progs) -> dict:
    return {dataclasses.astuple(p): n for p, n in progs.items()}


def test_plan_bootstrap_inventory_matches_reference():
    progs, out = planner.plan_bootstrap(preset("boot_ci_f"), radix_log=3, k_bound=5.0)
    rprogs, rout = rplanner.plan_bootstrap(ref_preset("boot_ci_f"), radix_log=3, k_bound=5.0)
    assert _inventory(progs) == _inventory(rprogs)
    assert (out.level, out.scale) == (rout.level, rout.scale)
    assert {"mod_raise", "eph_ks", "fan", "mult", "rescale", "conj"} <= {p.kind for p in progs}


FAMILIES = [
    ("mult", {}),
    ("fan", dict(n_offsets=3, n_sets=2, pt0_mask=(True, False))),
    ("conj", {}),
    ("eph_ks", {}),
]


@pytest.mark.parametrize("kind,geometry", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_lower_program_meta_counts_the_reference_elements(kind, geometry):
    params, rparams = preset("boot_ci_f"), ref_preset("boot_ci_f")
    level = params.num_limbs - (2 if kind == "conj" else 0)
    mesh = sh.make_fhe_mesh(2, 4, devices=["cpu"] * 8)
    (run, bundle), meta = planner.lower_program(planner.Program(kind, level, **geometry),
                                                params, mesh)
    rmesh = rsh.make_fhe_mesh(2, 4, devices=jax.devices()[:8])
    _, rmeta = rplanner.lower_program(rplanner.Program(kind, level, **geometry), rparams, rmesh)
    assert (meta["kind"], meta["level"]) == (rmeta["kind"], rmeta["level"])
    assert sorted(meta) == sorted(rmeta)
    for key in ("key_bytes_per_device", "pt_bytes_per_device"):
        if key in rmeta:
            assert meta[key] // 8 == rmeta[key] // 4, key
    assert callable(run) and bundle is not None


@pytest.mark.parametrize("kind,level", [("rescale", 17), ("mod_raise", 1)])
def test_lower_program_builds_the_keyless_programs(kind, level):
    """The programs without a key: a callable over a component grid."""
    params = preset("boot_ci_f")
    mesh = sh.make_fhe_mesh(2, 4, devices=["cpu"] * 8)
    (run, bundle), meta = planner.lower_program(planner.Program(kind, level), params, mesh)
    assert meta == {"kind": kind, "level": level} and bundle is None
    x = torch.zeros((level, params.n), dtype=torch.int64)
    out = run(sh.shard_ct_component(x, params, mesh))
    want = level - 1 if kind == "rescale" else params.num_limbs
    assert sh.unshard_ct_component(out).shape == (want, params.n)
