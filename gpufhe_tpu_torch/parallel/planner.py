"""Mesh program planner: the sharded bootstrap's program inventory, with no
keys and no data, and one program built from shapes.

Counterpart of gpufhe_tpu/parallel/planner.py.

* PlanBackend: a GhostBackend (ciphertext/backend.py) with the whole
  ShardedBackend op surface, recording every distinct MESH PROGRAM that
  the orchestration (bootstrap.py, fftboot.py, polyeval.py) would run: its
  kind, level and fan geometry. Driving the real Bootstrapper over it gives
  the program inventory and level schedule of a bootstrap: no keygen, no
  encodes, no device.
* lower_program: the reference lowers one inventory entry ahead of time
  from shapes; PyTorch runs eagerly, so here it builds the entry's
  (run, prepare) from a zero key and returns the same `meta`: kind, level
  and the per-shard residency of the key bundle and plaintexts
  (key_bytes_per_device, pt_bytes_per_device), from the bundles' shapes
  in the port's dtype, int64. The reference counts uint32, so its bytes
  are half of these: the element counts are equal.
"""

from __future__ import annotations

import dataclasses

import torch

from gpufhe_tpu_torch.ciphertext.backend import GhostBackend, GhostCiphertext
from gpufhe_tpu_torch.keys.keys import DeviceKSKey
from gpufhe_tpu_torch.ops.context import fourstep_split
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.parallel.mesh import FheMesh
from gpufhe_tpu_torch.primitives.rns import ks_groups


@dataclasses.dataclass(frozen=True)
class Program:
    """One distinct mesh program of the bootstrap pipeline."""

    kind: str  # mod_raise2 | mod_raise | eph_ks | fan | mult | rescale | conj
    level: int
    n_offsets: int = 0  # fan only
    n_sets: int = 0  # fan only
    pt0_mask: tuple = ()  # fan only


class _FakeChest:
    """Just enough chest for Bootstrapper to take the encapsulation path."""

    eph = {"to_eph": None, "from_eph": None}


class PlanBackend(GhostBackend):
    """Records the sharded program inventory while ghost-running the
    bootstrap orchestration (level and scale bookkeeping from GhostBackend;
    the op semantics of parallel/backend.py ShardedBackend)."""

    def __init__(self, params: CKKSParams):
        super().__init__(params)
        self.chest = _FakeChest()
        self.programs: dict[Program, int] = {}  # program -> call count
        self.ctx = None  # the ShardedBackend attribute surface

    def _rec(self, p: Program):
        self.programs[p] = self.programs.get(p, 0) + 1

    # -- mesh programs (each records its instantiation) ---------------------
    def mul(self, a, b):
        lvl = min(a.level, b.level)
        self._rec(Program("mult", lvl))
        # make_sharded_mult rescales ONCE; ShardedBackend.mul chains the
        # remaining scale_words - 1 rescales as separate programs
        for w in range(1, self.params.scale_words):
            self._rec(Program("rescale", lvl - w))
        return super().mul(GhostCiphertext(lvl, a.scale), GhostCiphertext(lvl, b.scale))

    def rescale(self, ct):
        lvl = ct.level
        for w in range(self.params.scale_words):
            self._rec(Program("rescale", lvl - w))
        return super().rescale(ct)

    def conjugate(self, ct):
        self._rec(Program("conj", ct.level))
        return GhostCiphertext(ct.level, ct.scale)

    def rotate_hoisted(self, ct, steps_list):
        steps = tuple(steps_list)
        self._rec(Program("fan", ct.level, n_offsets=len(steps)))
        return {s: GhostCiphertext(ct.level, ct.scale) for s in steps}

    def key_switch(self, ct, which: str):
        self._rec(Program("eph_ks", ct.level))
        return GhostCiphertext(ct.level, ct.scale)

    def mod_raise(self, ct):
        assert ct.level == self.params.scale_words
        self._rec(Program("mod_raise2" if self.params.scale_words == 2 else "mod_raise",
                          ct.level))
        return GhostCiphertext(self.params.num_limbs, ct.scale)

    # -- fused diagonal-fan stages (ShardedBackend.make_fan_plan mirror) ----
    def make_fan_plan(self, diag_sets, level: int, scale: float | None = None):
        scale = self.params.scale if scale is None else scale
        offsets = tuple(sorted({r for d in diag_sets for r in d if r != 0}))
        pt0_mask = tuple(0 in d for d in diag_sets)
        prog = Program("fan", level, n_offsets=len(offsets), n_sets=len(diag_sets),
                       pt0_mask=pt0_mask)
        return (prog, scale)

    def apply_fan(self, ct, plan):
        prog, pt_scale = plan
        assert ct.level == prog.level, (ct.level, prog.level)
        self._rec(prog)
        scale = ct.scale * pt_scale
        lvl = prog.level
        for _ in range(self.params.scale_words):
            scale = scale / self.params.q_primes[lvl - 1]
            lvl -= 1
        return [GhostCiphertext(lvl, scale) for _ in range(prog.n_sets)]


def plan_bootstrap(params: CKKSParams, radix_log: int, k_bound: float,
                   cheb_baby_log: int = 3):
    """Ghost-run the full bootstrap and return its program inventory."""
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper

    be = PlanBackend(params)
    bs = Bootstrapper(be, transform="factored", radix_log=radix_log, evalmod="cheb",
                      k_bound=k_bound, cheb_baby_log=cheb_baby_log, fuse_evalmod=False)
    ct = GhostCiphertext(params.scale_words, params.scale)
    out = bs(ct)
    return be.programs, out


# ---------------------------------------------------------------------------
# One inventory entry built from shapes
# ---------------------------------------------------------------------------


def _fake_ks_key(params: CKKSParams, device) -> DeviceKSKey:
    """A zero DeviceKSKey at full gadget rank (the shape donor)."""
    dnum = len(ks_groups(params, params.num_limbs))
    t = params.num_limbs + len(params.p_primes)
    z = torch.zeros((dnum, t, params.n), dtype=torch.int64, device=device)
    return DeviceKSKey(z, z)


def _bytes_per_shard(*grids) -> int:
    """The most bytes that one shard holds of these grids of blocks."""
    per = {}
    for grid in grids:
        for i, row in enumerate(grid):
            for c, b in enumerate(row):
                per[i, c] = per.get((i, c), 0) + b.numel() * b.element_size()
    return max(per.values(), default=0)


def lower_program(prog: Program, params: CKKSParams, mesh: FheMesh):
    """Build one mesh program from a zero key.

    Returns ((run, bundle), meta): the program and its key bundle (None
    for the programs without a key), and meta with kind, level and, where
    the program holds keys or plaintexts, their bytes per shard."""
    from gpufhe_tpu_torch.parallel import sharded as sh
    from gpufhe_tpu_torch.parallel.backend import ShardedBackend

    n1, n2 = fourstep_split(params.n)
    n_coeff = mesh.shape["coeff"]
    k = prog.level
    alpha = len(params.p_primes)
    fake_key = _fake_ks_key(params, mesh.devices[0][0])
    meta = {"kind": prog.kind, "level": k}
    if prog.kind == "mult":
        run, prepare = sh.make_sharded_mult(params, k, mesh)
        bundle = prepare(fake_key)
        meta["key_bytes_per_device"] = _bytes_per_shard(bundle[0].key_b, bundle[0].key_a)
    elif prog.kind == "fan":
        n_sets = max(prog.n_sets, 1)
        pt0_mask = prog.pt0_mask or (False,) * n_sets
        run, prepare = sh.make_sharded_fan(params, k, mesh, prog.n_offsets, n_sets, pt0_mask)
        bundle = prepare([fake_key] * prog.n_offsets, fake_key)
        meta["key_bytes_per_device"] = _bytes_per_shard(*(g for kb_ka in bundle[1]
                                                          for g in kb_ka))
        # per set [R, K+alpha, n1/C, n2] plaintexts, and a pt0 [K+alpha, n1/C, n2]
        per_set = prog.n_offsets * (k + alpha) * (n1 // n_coeff) * n2
        pt0 = sum(pt0_mask) * (k + alpha) * (n1 // n_coeff) * n2
        meta["pt_bytes_per_device"] = 8 * (n_sets * per_set + pt0)
    elif prog.kind in ("conj", "eph_ks", "rotation"):
        g = 2 * params.n - 1 if prog.kind == "conj" else 1
        run, prepare = sh._make_sharded_galois(params, k, mesh, g)
        bundle = prepare(fake_key)
        meta["key_bytes_per_device"] = _bytes_per_shard(bundle[0].key_b, bundle[0].key_a)
    elif prog.kind == "rescale":
        run, bundle = ShardedBackend(params, mesh, chest=None)._rescale_fn(k), None
    elif prog.kind == "mod_raise2":
        run, bundle = ShardedBackend(params, mesh, chest=None)._mod_raise2_fn(), None
    elif prog.kind == "mod_raise":
        run, bundle = ShardedBackend(params, mesh, chest=None)._mod_raise_fn(), None
    else:
        raise ValueError(prog.kind)
    return (run, bundle), meta
