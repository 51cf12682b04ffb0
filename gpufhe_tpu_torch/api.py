"""User-facing session API: one object per (scheme, parameter set).

Counterpart of gpufhe_tpu/api.py, on the port's backends. The modular
layers (params / keys / ciphertext / backends) stay the power-user surface;
`Session` is the facade a user of a conventional FHE library expects:
create once, then encrypt / evaluate / decrypt without touching contexts,
chests or backends:

    from gpufhe_tpu_torch import Session

    s = Session.create("bfv_tiny", scheme="bfv", rotations="bsgs")
    ct = s.encrypt(values)                       # integers mod t
    out = s.matmul(s.mul(ct, ct), A)             # exact homomorphic algebra
    print(s.decrypt(out))

Scheme semantics:
  * ckks — approximate complex slots; `mul` rescales (one level), values
    are length-`slots` arrays.
  * bgv  — exact integers mod t; `mul` mod-switches (one level); values are
    per-ring [n/2] or [2, n/2] arrays (orbit order).
  * bfv  — exact integers mod t; `mul` keeps the level (scale-invariant).

A session runs on the card; `device="cpu"` (keyword-only, on `create`,
`load` and `create_threshold`) builds its context on the CPU, where every
kernel runs its plain PyTorch version. The keys are the golden keygen's,
drawn from numpy.random.default_rng(seed) in the reference's order, and
every encrypt draws from the same Generator in the same order, so a seed
gives the reference's keys and ciphertexts limb for limb.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gpufhe_tpu_torch.ciphertext import linalg
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.params.params import preset as _preset


@dataclasses.dataclass
class Session:
    params: CKKSParams
    scheme: str
    ctx: object
    chest: object
    be: object
    _rng: np.random.Generator
    _boot_kw: dict | None = None
    _bootstrapper: object | None = None

    # -- construction ---------------------------------------------------------
    @classmethod
    def create(
        cls,
        params_or_preset,
        scheme: str | None = None,
        rotations=(),
        conjugation: bool = False,
        seed: int = 0,
        bootstrap=False,
        *,
        device: str = "cuda",
    ) -> "Session":
        """rotations: explicit step tuple, or "bsgs" for the full BSGS set
        the matmul layer needs. scheme defaults to ckks when the preset has
        no plain modulus, else bgv (pass "bfv" explicitly for BFV).
        bootstrap: True (or a dict of Bootstrapper kwargs, e.g.
        {"evalmod": "cheb", "transform": "factored"}) adds the bootstrap
        rotation set + conjugation key and enables `Session.bootstrap`.
        device: where the context and keys live (the card by default)."""
        params = (
            _preset(params_or_preset)
            if isinstance(params_or_preset, str)
            else params_or_preset
        )
        if scheme is None:
            scheme = "bgv" if params.plain_modulus else "ckks"
        assert scheme in ("ckks", "bgv", "bfv")
        assert (scheme == "ckks") == (params.plain_modulus == 0), (
            "integer schemes need plain_modulus; ckks needs plain_modulus=0"
        )
        if rotations == "bsgs":
            rotations = tuple(linalg.bsgs_rotations(params.slots))
        boot_kw = None
        if bootstrap:
            assert scheme == "ckks", "bootstrapping is CKKS-only"
            boot_kw = dict(bootstrap) if isinstance(bootstrap, dict) else {}
            from gpufhe_tpu_torch.ciphertext.bootstrap import bootstrap_rotations

            rotations = tuple(sorted(
                set(rotations) | set(bootstrap_rotations(
                    params,
                    transform=boot_kw.get("transform", "dense"),
                    radix_log=boot_kw.get("radix_log", 3),
                ))
            ))
            conjugation = True
        rng = np.random.default_rng(seed)
        ctx = make_context(params, device=device)
        if scheme == "ckks":
            from gpufhe_tpu_torch.keys import keys as dkeys

            chest = dkeys.keygen(
                params, rng, rotations=tuple(rotations), conjugation=conjugation, ctx=ctx
            )
        elif scheme == "bgv":
            from gpufhe_tpu_torch.ciphertext import bgv as dbgv

            chest = dbgv.keygen(params, rng, rotations=tuple(rotations), ctx=ctx)
        else:
            from gpufhe_tpu_torch.ciphertext import bfv as dbfv

            chest = dbfv.keygen(params, rng, rotations=tuple(rotations), ctx=ctx)
        be = cls._make_backend(params, ctx, chest, scheme)
        return cls(params, scheme, ctx, chest, be, rng, _boot_kw=boot_kw)

    @staticmethod
    def _make_backend(params, ctx, chest, scheme):
        if scheme == "ckks":
            from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend

            return DeviceBackend(params, ctx, chest)
        if scheme == "bgv":
            from gpufhe_tpu_torch.ciphertext.bgv_backend import BGVDeviceBackend

            return BGVDeviceBackend(params, ctx, chest)
        from gpufhe_tpu_torch.ciphertext.bfv_backend import BFVDeviceBackend

        return BFVDeviceBackend(params, ctx, chest)

    # -- persistence -----------------------------------------------------------
    def save(self, path) -> None:
        """Persist the session (params + all golden key material) to one npz
        in the reference's format; `Session.load(path)` restores it with the
        device mirrors re-uploaded. Ciphertexts travel separately:
        `save_ct` / `load_ct`."""
        from gpufhe_tpu_torch.utils import serialization

        serialization.save_keychest(path, self.chest, scheme=self.scheme)

    @classmethod
    def load(cls, path, seed: int = 0, *, device: str = "cuda") -> "Session":
        import json

        from gpufhe_tpu_torch.utils import serialization

        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
        ctx = make_context(serialization.params_from_dict(meta["params"]), device=device)
        scheme, chest = serialization.load_keychest(path, with_scheme=True, ctx=ctx)
        params = chest.params
        be = cls._make_backend(params, ctx, chest, scheme)
        return cls(params, scheme, ctx, chest, be, np.random.default_rng(seed))

    def save_ct(self, path, ct) -> None:
        from gpufhe_tpu_torch.utils import serialization

        serialization.save_ciphertext(path, ct)

    def load_ct(self, path):
        from gpufhe_tpu_torch.utils import serialization

        return serialization.load_ciphertext(path, ctx=self.ctx)

    # -- encrypt / decrypt ----------------------------------------------------
    def encrypt(self, values, level: int | None = None):
        """ckks: complex/real [slots]; bgv/bfv: [n/2] or [2, n/2] mod t."""
        if self.scheme == "ckks":
            from gpufhe_tpu_torch.ciphertext import ct as dct
            from gpufhe_tpu_torch.encoding import encoder

            z = np.asarray(values, dtype=np.complex128)
            assert z.shape == (self.params.slots,)
            return dct.encrypt(
                encoder.encode(z, self.params), self.params,
                self.chest.device_pk, self.ctx, self._rng, self.params.scale,
                level=level,
            )
        from gpufhe_tpu_torch.ciphertext.bgv_backend import _orbit_to_raw

        raw = _orbit_to_raw(values, self.be.rings, self.be.t, self.params.n)
        if self.scheme == "bgv":
            from gpufhe_tpu_torch.ciphertext import bgv as dev
            from gpufhe_tpu_torch.golden import bgv as gold
        else:
            from gpufhe_tpu_torch.ciphertext import bfv as dev
            from gpufhe_tpu_torch.golden import bfv as gold
        return dev.encrypt(
            gold.encode(raw, self.params), self.params, self.chest.device_pk,
            self.ctx, self._rng, level=level,
        )

    def decrypt(self, ct):
        """ckks: complex [slots]; bgv/bfv: int [2, n/2] orbit rings."""
        return self.be.decrypt_decode(ct)

    # -- homomorphic ops -------------------------------------------------------
    def add(self, a, b):
        return self.be.add(a, b)

    def sub(self, a, b):
        return self.be.sub(a, b)

    def mul(self, a, b):
        """One level-normalized multiply: ckks mul_full (tensor + relin +
        rescale inside), bgv mul (+modswitch inside), bfv mul (level kept)."""
        return self.be.mul(a, b)

    def mul_plain(self, ct, values):
        lvl = self.be.level(ct)
        if self.scheme == "ckks":
            pt = self.be.encode_slots(
                np.asarray(values, dtype=np.complex128), self.params.scale, lvl
            )
            return self.be.rescale(self.be.mul_plain(ct, pt))
        return self.be.mul_plain(ct, self.be.encode_slots(values, 1.0, lvl))

    def add_plain(self, ct, values):
        return self.be.add_plain(ct, values)

    def rotate(self, ct, steps: int):
        if self.scheme == "ckks":
            return self.be.rotate_hoisted(ct, [steps])[steps]
        return self.be.rotate(ct, steps)

    def rescale(self, ct):
        """Level-consuming normalization (ckks rescale / bgv modswitch /
        bfv modulus reduction)."""
        return self.be.rescale(ct)

    def matmul(self, ct, a: np.ndarray):
        """Plaintext-matrix x ciphertext (BSGS; needs rotations="bsgs")."""
        return linalg.matmul_plain(self.be, ct, a)

    def level(self, ct) -> int:
        return self.be.level(ct)

    def bootstrap(self, ct):
        """Refresh an exhausted CKKS ciphertext back to a high level
        (ModRaise -> CoeffToSlot -> EvalMod -> SlotToCoeff). Needs
        `Session.create(..., bootstrap=True)` (adds the rotation set +
        conjugation key; pass a dict for Bootstrapper kwargs)."""
        self._ckks_only("bootstrap")
        assert self._boot_kw is not None, (
            "create the session with bootstrap=True (or a Bootstrapper "
            "kwargs dict) — bootstrapping needs its Galois keys at keygen"
        )
        if self._bootstrapper is None:
            from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper

            self._bootstrapper = Bootstrapper(self.be, **self._boot_kw)
        return self._bootstrapper(ct)

    def noise_budget(self, ct) -> float:
        """Bits of noise headroom left before decryption fails (BGV: before
        t*e wraps Q; BFV: rounding margin log2(Delta/2|e|)). The
        exact-scheme analogue of CKKS scale/level tracking — a mult chain
        must stop (or scheme-switch to a fresh encryption) before this
        reaches 0. Diagnostic only: uses the secret key, on the host (the
        limbs are read back through .cpu())."""
        assert self.scheme in ("bgv", "bfv"), (
            "noise_budget is for the exact schemes; CKKS tracks scale/level"
        )
        if self.scheme == "bgv":
            from gpufhe_tpu_torch.golden import bgv as gold
        else:
            from gpufhe_tpu_torch.golden import bfv as gold
        return gold.noise_budget_bits(ct, self.params, self.chest.sk)

    # -- ckks-only non-linear toolkit (compare.py / approx.py) ---------------
    def _ckks_only(self, what: str):
        assert self.scheme == "ckks", f"{what} is CKKS-only (approximate)"

    def sign(self, ct, **kw):
        """sign(x) for slots in [-1, 1] (composite minimax polynomials)."""
        self._ckks_only("sign")
        from gpufhe_tpu_torch.ciphertext import compare

        return compare.sign(self.be, ct, **kw)

    def relu(self, ct, **kw):
        self._ckks_only("relu")
        from gpufhe_tpu_torch.ciphertext import compare

        return compare.relu(self.be, ct, **kw)

    def inverse(self, ct, bound: float = 1.0, iters: int = 6, **kw):
        """1/x for slots in (0, bound] (Goldschmidt)."""
        self._ckks_only("inverse")
        from gpufhe_tpu_torch.ciphertext import approx

        return approx.inverse(self.be, ct, bound=bound, iters=iters, **kw)

    def sqrt(self, ct, bound: float = 1.0, iters: int = 6):
        self._ckks_only("sqrt")
        from gpufhe_tpu_torch.ciphertext import approx

        return approx.sqrt(self.be, ct, bound=bound, iters=iters)

    def exp(self, ct, half_range: float = 1.0, **kw):
        self._ckks_only("exp")
        from gpufhe_tpu_torch.ciphertext import approx

        return approx.exp(self.be, ct, half_range=half_range, **kw)

    def softmax(self, ct, **kw):
        """softmax over all slots; needs the rotations from
        approx.rotations_for_softmax(slots) in the key chest."""
        self._ckks_only("softmax")
        from gpufhe_tpu_torch.ciphertext import approx

        return approx.softmax(self.be, ct, **kw)


class ThresholdSession(Session):
    """Multiparty session: no party (and no session object) ever holds the
    joint secret key. Keys come from the interactive protocols in
    ciphertext/threshold.py — additive secret shares, aggregated public key,
    two-round collaborative relinearization, one-round collaborative Galois
    keys — so the full homomorphic surface (add/mul/rotate/matmul) works
    unchanged; only decryption changes: every party contributes a smudged
    `partial_decrypt`, combined by `combine`.

        ts = ThresholdSession.create_threshold("tiny2", n_parties=3)
        ct = ts.encrypt(values)                       # under the joint pk
        out = ts.mul(ct, ct)
        vals = ts.combine(out, [ts.partial_decrypt(out, i) for i in range(3)])

    This object holds ALL party shares in-process (`shares`) to model the
    protocol for tests/orchestration; a production deployment keeps each
    share on its own host and exchanges only the h*/partial messages (see
    threshold.py security notes — smudge_sigma must flood ciphertext noise).
    The protocol runs on the host; its keys are uploaded to the session's
    device (the card by default).
    """

    shares: list = None

    @classmethod
    def create_threshold(
        cls,
        params_or_preset,
        n_parties: int,
        scheme: str | None = None,
        rotations=(),
        seed: int = 0,
        *,
        device: str = "cuda",
    ) -> "ThresholdSession":
        from gpufhe_tpu_torch.ciphertext import threshold as th
        from gpufhe_tpu_torch.keys.keys import upload_ks_key, upload_public_key

        params = (
            _preset(params_or_preset)
            if isinstance(params_or_preset, str)
            else params_or_preset
        )
        if scheme is None:
            scheme = "bgv" if params.plain_modulus else "ckks"
        assert scheme in ("ckks", "bgv", "bfv")
        if rotations == "bsgs":
            rotations = tuple(linalg.bsgs_rotations(params.slots))
        ctx = make_context(params, device=device)
        a = th.common_a(params, seed=seed)
        shares = [
            th.party_keygen(params, a, np.random.default_rng(seed * 1000 + 100 + i))
            for i in range(n_parties)
        ]
        pk = th.aggregate_public_key(params, a, [s.b for s in shares])
        rlk = th.collaborative_relin_key(params, shares, seed=seed)
        galois = {
            steps: (gk, upload_ks_key(gk, params, ctx=ctx))
            for steps in rotations
            for gk in [th.collaborative_galois_key(params, shares, steps,
                                                   seed=seed + steps)]
        }
        device_pk = upload_public_key(pk, params, ctx=ctx)
        device_rlk = upload_ks_key(rlk, params, ctx=ctx)
        if scheme == "ckks":
            from gpufhe_tpu_torch.keys.keys import KeyChest

            chest = KeyChest(
                params=params, sk=None, pk=pk, rlk=rlk, device_sk=None,
                device_pk=device_pk, device_rlk=device_rlk, galois=galois,
                conj=None,
            )
        elif scheme == "bgv":
            from gpufhe_tpu_torch.ciphertext.bgv import BGVKeyChest

            chest = BGVKeyChest(
                params=params, sk=None, pk=pk, rlk=rlk, device_sk=None,
                device_pk=device_pk, device_rlk=device_rlk, galois=galois,
            )
        else:
            from gpufhe_tpu_torch.ciphertext.bfv import BFVKeyChest

            chest = BFVKeyChest(
                params=params, sk=None, pk=pk, rlk=rlk, device_sk=None,
                device_pk=device_pk, device_rlk=device_rlk, galois=galois,
            )
        be = cls._make_backend(params, ctx, chest, scheme)
        s = cls(params, scheme, ctx, chest, be, np.random.default_rng(seed))
        s.shares = shares
        return s

    def decrypt(self, ct):
        raise RuntimeError(
            "threshold sessions have no joint secret key: collect "
            "partial_decrypt(ct, i) from every party and combine(ct, partials)"
        )

    def partial_decrypt(self, ct, party: int, rng=None, smudge_sigma: float = 16.0):
        """Party `party`'s smudged decryption share p_i = c1*s_i + e. Size
        smudge_sigma per deployment (threshold.py security notes)."""
        from gpufhe_tpu_torch.ciphertext import threshold as th

        rng = rng if rng is not None else self._rng
        return th.partial_decrypt(
            ct, self.params, self.shares[party], rng, smudge_sigma=smudge_sigma,
        )

    def combine(self, ct, partials: list):
        """c0 + sum(partials) -> decoded values (needs ALL parties). The host
        protocol reads the ciphertext's limbs back from its device."""
        from gpufhe_tpu_torch.ciphertext import threshold as th

        if self.scheme == "ckks":
            return th.decrypt_ckks(ct, self.params, partials)
        from gpufhe_tpu_torch.golden import bgv as gold

        dec = th.decrypt_bgv if self.scheme == "bgv" else th.decrypt_bfv
        raw = gold.decode(dec(ct, self.params, partials), self.params)
        # raw slot vector [n] -> the backends' orbit-ring convention [2, n/2]
        rings = gold.slot_orbit_rings(self.params)
        return np.stack([raw[rings[0]], raw[rings[1]]])
