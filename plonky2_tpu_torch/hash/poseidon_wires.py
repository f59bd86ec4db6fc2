"""The Poseidon gate's witness waves: the plain version of kernel K7.

The port's counterpart of plonky2_tpu/hash/poseidon_wires_jax.py.  The
device witness plan (iop/device_witness.py) runs every ready PoseidonGate
row of a wave at once: each row's 12 inputs and swap wire give the gate's
122 other wires, on the fast partial-round schedule (hash/poseidon.py:
poseidon_fast_t) with every S-box input recorded, in the column order of
``PoseidonGenerator.output_targets``:

    4 deltas | 36 full_sbox_0 (rounds 1-3) | 22 partial_sbox
    | 48 full_sbox_1 | 12 outputs.

A full round's S-box inputs are its state after the constant layer; a
partial round's is the fast schedule's s[0] before its S-box.  Every
value is canonical (a witness wire).  ``poseidon_wires`` runs one wave:
gather from the plan's slot buffer, ``poseidon_wire_batch``, scatter.
``poseidon_wires_waves``, K7's plain version, runs a run of consecutive
waves in order, each reading what the ones before it wrote;
hash/poseidon_cuda.py:poseidon_wires_waves_cuda is its wrapper.
"""
from __future__ import annotations

import torch

from ..field import gf
from . import poseidon as pos

WIDTH = pos.WIDTH
HALF = pos.HALF_N_FULL_ROUNDS
NPR = pos.N_PARTIAL_ROUNDS
NUM_OUTPUT_WIRES = 4 + WIDTH * (HALF - 1) + NPR + WIDTH * HALF + WIDTH  # 122


def poseidon_wire_batch(dep: torch.Tensor) -> torch.Tensor:
    """dep: (G, 13) int64, each row 12 inputs and the swap wire -> (122, G)
    wire values in ``PoseidonGenerator.output_targets`` order."""
    dev = str(dep.device)
    rc, mds = pos._tables(dev)
    first, init, prc, w_hats, vs = pos._fast_tables(dev)
    ins = dep[:, :WIDTH].T                                # (12, G)
    swap = dep[:, WIDTH]
    a, b = ins[:4], ins[4:8]
    cols = [gf.mul(swap[None], gf.sub(b, a))]             # the deltas
    do_swap = (swap == 1)[None]
    state = torch.cat([torch.where(do_swap, b, a), torch.where(do_swap, a, b),
                       ins[8:]])

    def constant_layer(st, r):
        return gf.add(st, rc[r])

    def sbox_mds(st):
        return pos._mds(pos._sbox(st), mds)

    for r in range(HALF):
        state = constant_layer(state, r)
        if r:
            cols.append(state)
        state = sbox_mds(state)
    state = gf.add(state, first)
    # rest[c - 1] = sum_r init[r - 1][c - 1] * state[r] for c >= 1
    rest = pos._sum_rows(gf.mul(state[1:, None], init))
    s0 = state[0]
    for r in range(NPR):
        cols.append(s0[None])
        x0 = gf.add(pos._sbox(s0), prc[r])
        s0 = gf.add(gf.mul(x0, pos.FAST_MS0),
                    pos._sum_rows(gf.mul(rest, w_hats[r])))
        rest = gf.add(rest, gf.mul(x0[None], vs[r]))
    state = torch.cat([s0[None], rest])
    for r in range(HALF + NPR, pos.N_ROUNDS):
        state = constant_layer(state, r)
        cols.append(state)
        state = sbox_mds(state)
    cols.append(state)
    return torch.cat(cols)


def poseidon_wires(values: torch.Tensor, dep_idx: torch.Tensor,
                   out_idx: torch.Tensor, err: torch.Tensor) -> None:
    """Plain version of K7, in place: values[out_idx] = the wires of the
    rows whose inputs and swap wire are values[dep_idx] (dep_idx (13, G),
    out_idx (122, G)); err[0] becomes nonzero if a swap wire is not 0 or
    1."""
    dep = values[dep_idx]                                 # (13, G)
    swap = dep[WIDTH]
    err |= ((swap != 0) & (swap != 1)).any().to(err.dtype)
    values[out_idx] = poseidon_wire_batch(dep.T)


def poseidon_wires_waves(values: torch.Tensor, dep_idx: torch.Tensor,
                         out_idx: torch.Tensor, offsets,
                         err: torch.Tensor) -> None:
    """Plain version of K7, in place: the waves of a run, in order; wave v
    is the columns [offsets[v], offsets[v + 1]) of dep_idx (13, R) and
    out_idx (122, R)."""
    for a, b in zip(offsets, offsets[1:]):
        poseidon_wires(values, dep_idx[:, a:b], out_idx[:, a:b], err)
