"""The ('limb', 'coeff') mesh of shards and its collectives: the port's
stand-in for jax.sharding.Mesh and the jax.lax collectives that
gpufhe_tpu/parallel/sharded.py calls inside jax.shard_map.

A shard_map program is single-controller: one process drives every device
of its mesh. So is this one. An `FheMesh` is a grid of torch devices, one
per shard, and a device may repeat: eight shards on "cuda:0" on one card,
or ["cpu"] * 8 in the tests. A sharded tensor is its per-shard blocks, a
list of rows (one per limb index held here) of n_coeff blocks each. The
programs of parallel/sharded.py run their body over those blocks shard by
shard, and the collectives below move blocks between shards: blocks on one
device are sliced and concatenated, blocks on different devices are moved
with .to(device). Shards on one device share one result of an all_gather or
an allreduce (the blocks are never written in place).

Across processes (multihost.global_fhe_mesh) the limb axis spans
torch.distributed ranks, each holding its rows of local devices; the coeff
axis stays in the process. The one collective the programs take over the
limb axis, the all_gather of the key switch's exact modular allreduce, then
goes through torch.distributed.all_gather, in rank order.
"""

from __future__ import annotations

import torch

from gpufhe_tpu_torch.ops.modops import add_mod

AXES = ("limb", "coeff")


class FheMesh:
    """A grid of torch devices: n_limb x n_coeff shards, or this process's
    rows of them (`rows`, the limb indices held here) when the limb axis
    spans torch.distributed ranks (`distributed`)."""

    def __init__(self, n_limb: int, n_coeff: int, devices, *, rows=None,
                 distributed: bool = False):
        self.rows = tuple(range(n_limb)) if rows is None else tuple(rows)
        flat = [torch.device(d) for d in _flatten(devices)]
        if n_limb < 1 or n_coeff < 1 or len(flat) != len(self.rows) * n_coeff:
            raise ValueError(f"{len(flat)} devices for {len(self.rows)} rows of {n_coeff} shards")
        self.shape = {"limb": n_limb, "coeff": n_coeff}
        self.devices = tuple(tuple(flat[i * n_coeff:(i + 1) * n_coeff])
                             for i in range(len(self.rows)))
        self.distributed = distributed

    def __repr__(self) -> str:
        return (f"FheMesh(limb={self.shape['limb']}, coeff={self.shape['coeff']}, "
                f"rows={self.rows}, devices={[str(d) for r in self.devices for d in r]})")

    @property
    def distinct_devices(self) -> list:
        return list(dict.fromkeys(d for r in self.devices for d in r))

    def map(self, fn, *grids):
        """fn(*blocks) of each shard: a new grid."""
        return [[fn(*(g[i][c] for g in grids)) for c in range(len(row))]
                for i, row in enumerate(self.devices)]

    def put(self, make):
        """The grid of make(limb, coeff, device) over this process's shards."""
        return [[make(l, c, dev) for c, dev in enumerate(row)]
                for l, row in zip(self.rows, self.devices)]

    # -- the collectives, tiled as jax.lax's over one mesh axis ---------------
    def _groups(self, axis: str) -> list:
        """The shards (local row i, coeff c) of each group along `axis`."""
        if axis not in AXES:
            raise ValueError(f"no mesh axis {axis!r}")
        n_rows, n_coeff = len(self.rows), self.shape["coeff"]
        if axis == "coeff":
            return [[(i, c) for c in range(n_coeff)] for i in range(n_rows)]
        return [[(i, c) for i in range(n_rows)] for c in range(n_coeff)]

    def all_to_all(self, blocks, axis: str, split_axis: int, concat_axis: int):
        """Shard k of a group splits its block along split_axis into one
        chunk per member and sends chunk j to member j, which concatenates
        what it receives along concat_axis in member order."""
        if axis == "limb" and self.distributed:
            raise ValueError("all_to_all over the limb axis does not cross processes")
        out = [list(r) for r in blocks]
        for group in self._groups(axis):
            parts = [blocks[i][c] for i, c in group]
            chunks = [p.chunk(len(group), dim=split_axis) for p in parts]
            for j, (i, c) in enumerate(group):
                dev = self.devices[i][c]
                out[i][c] = torch.cat([ch[j].to(dev) for ch in chunks], dim=concat_axis)
        return out

    def all_gather(self, blocks, axis: str, dim: int):
        """Every member of a group gets the group's blocks concatenated along
        dim in member order (over the limb axis, in global row order)."""
        return self._reduce(blocks, axis, lambda parts, dev: torch.cat(
            [p.to(dev) for p in parts], dim=dim))

    def modular_allreduce(self, blocks, q, axis: str = "limb"):
        """The exact sum mod q across a mesh axis (sharded.py:184): an
        all_gather, then add_mod in member order. q(device) gives the
        modulus column on a shard's device."""
        def add(parts, dev):
            acc = parts[0].to(dev)
            for p in parts[1:]:
                acc = add_mod(acc, p.to(dev), q(dev))
            return acc
        return self._reduce(blocks, axis, add)

    def _reduce(self, blocks, axis: str, combine):
        """Each group's blocks combined once per device (all of the group's
        blocks, across processes too), shared by the members on it."""
        out = [list(r) for r in blocks]
        for group in self._groups(axis):
            parts = [blocks[i][c] for i, c in group]
            if axis == "limb" and self.distributed:
                parts = _gather_ranks(parts)
            done = {}
            for i, c in group:
                dev = self.devices[i][c]
                if dev not in done:
                    done[dev] = combine(parts, dev)
                out[i][c] = done[dev]
        return out


def _flatten(devices) -> list:
    out = []
    for d in devices:
        out.extend(_flatten(d) if isinstance(d, (list, tuple)) else [d])
    return out


def _gather_ranks(parts: list) -> list:
    """This process's blocks of one limb column, and every other rank's, in
    rank order (torch.distributed.all_gather of their stack)."""
    import torch.distributed as dist

    comm = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = torch.stack([p.to(comm) for p in parts])
    got = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(got, mine)
    return [p for g in got for p in g.unbind(0)]

