"""Emulate the index arithmetic of the NTT kernels (csrc/ntt.cu) on the CPU.

    python3 scripts/port_ntt_emulate.py

The column and row kernels are replayed in Python, round by round and
work item by work item, with the kernels' slot mapping, shared-memory
layout (``pad``, ``line_words``), twiddle indices, zero-tail factors and
store orders; the results are held equal to the plain versions in
``plonky2_tpu_torch/ops/ntt_cuda.py`` at small shapes.  Then, at the main
paths' shapes, every shared-memory access of one block is grouped by warp
(32 consecutive work items or store elements) and the bank-conflict degree
is printed per phase: 1.0 means each half-warp of 8-byte accesses touches
16 distinct banks pairs, 2.0 that it takes two passes.  No card is needed.
"""
from __future__ import annotations

import collections
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from plonky2_tpu_torch.field import fft  # noqa: E402
from plonky2_tpu_torch.field import goldilocks as gl  # noqa: E402
from plonky2_tpu_torch.field.convert import from_u64, to_u64  # noqa: E402
from plonky2_tpu_torch.ops import ntt_cuda as nc  # noqa: E402
from plonky2_tpu_torch.utils.bits import reverse_bits  # noqa: E402

P = gl.P
KMAX = 4
ROW_TILE_WORDS = 4096


def pad(p):
    return p + (p >> 4) + (p >> 8)


def line_words(n):
    return pad(n) | 1


def rev(x, bits):
    return reverse_bits(x, bits) if bits else 0


class Banks:
    """Bank-conflict degree of 8-byte shared-memory accesses, per phase."""

    def __init__(self):
        self.stats = collections.defaultdict(lambda: [0, 0])

    def access(self, phase, addrs):
        deg = 0
        for half in (addrs[:16], addrs[16:]):
            banks = collections.defaultdict(set)
            for a in half:
                banks[a % 16].add(a)
            deg += max((len(s) for s in banks.values()), default=0)
        self.stats[phase][0] += deg
        self.stats[phase][1] += 2

    def report(self):
        return {k: round(v[0] / v[1], 2) for k, v in self.stats.items()}


def rounds(L):
    """(round, k, s_lo, s_top): L mod 4 stages first, then fours."""
    nr = 1 if L == 0 else (L + KMAX - 1) // KMAX
    out, s_top = [], L
    for rd in range(nr):
        k = L - KMAX * (nr - 1) if rd == 0 else KMAX
        out.append((rd, k, s_top - k, s_top))
        s_top -= k
    return out


def dif_stages(v, tw, k, s_lo, lo):
    for b in range(k - 1, -1, -1):
        h = 1 << b
        for m in range(h):
            w = tw[(1 << (s_lo + b)) - 1 + lo + (m << s_lo)]
            if s_lo == 0 and (b == 0 or m == 0):
                assert w == 1
            for g in range(0, 1 << k, 2 * h):
                x, y = v[g + m], v[g + m + h]
                v[g + m], v[g + m + h] = (x + y) % P, (x - y) * w % P


def run_rounds(L, items_of, item, load, store_last, work, S, tw, banks, tag):
    """The kernel's dif_rounds: store_last is None for the row forms."""
    plan = rounds(L)
    for rd, k, s_lo, s_top in plan:
        last = store_last is not None and rd == len(plan) - 1
        stride = pad(1 << s_lo)
        maps = [item(w, s_lo, s_top) for w in range(items_of(k))]
        for w0 in range(0, len(maps), 32):
            warp = maps[w0:w0 + 32]
            for j in range(1 << k):
                addrs = [line * S + pad((hi << s_top) + lo) + j * stride
                         for line, lo, hi in warp]
                if rd > 0:
                    banks.access(f"{tag} round {rd} load", addrs)
                if not last:
                    banks.access(f"{tag} round {rd} store", addrs)
        results = []
        for line, lo, hi in maps:
            base = (hi << s_top) + lo
            for j in range(1 << k):     # the kernels' fixed stride
                assert pad(base + (j << s_lo)) == pad(base) + j * stride
            v = [load(line, base + (j << s_lo)) if rd == 0 else
                 work[line * S + pad(base) + j * stride]
                 for j in range(1 << k)]
            dif_stages(v, tw, k, s_lo, lo)
            results.append((line, base, v))
        for line, base, v in results:
            for j in range(1 << k):
                if last:
                    store_last(line, base + (j << s_lo), v[j])
                else:
                    work[line * S + pad(base) + j * stride] = v[j]


def cols_kernel(x, natural, q, log_n1, inverse, pre, post, log_t, banks):
    """ntt_cols_kernel<natural> on x (B, q, n2) of Python ints."""
    B, _, n2 = x.shape
    log_q = max(0, (q - 1).bit_length())
    Q, T, r = 1 << log_q, 1 << log_t, log_n1 - log_q
    n1 = 1 << log_n1
    tw = [int(t) for t in fft.twiddle_table(n1, inverse)][:Q]
    factor = [int(f) for f in nc.zero_tail_factors_u64(n1, r)]
    out = np.zeros((B, n1, n2), dtype=object)
    S = line_words(Q)
    for b in range(B):
        for j0 in range(0, n2, T):
            work = [None] * (T * S)
            prefix = [0] * (Q * T)
            for kk in range(Q * T if r > 0 else 0):
                i, c = kk >> log_t, kk & (T - 1)
                if i < q:
                    v = int(x[b, i, j0 + c])
                    prefix[kk] = v * int(pre[i, j0 + c]) % P \
                        if pre is not None else v
            for seg in range(1 << r):
                def item(w, s_lo, s_top):
                    rest = w >> log_t
                    return w & (T - 1), rest & ((1 << s_lo) - 1), rest >> s_lo

                def load(c, p):
                    if r > 0:
                        v = prefix[(p << log_t) + c]
                        return v * factor[(seg << log_q) + p] % P if seg else v
                    if p >= q:
                        return 0
                    v = int(x[b, p, j0 + c])
                    return v * int(pre[p, j0 + c]) % P \
                        if pre is not None else v

                def store(c, p, v):
                    slot = (seg << log_q) + p
                    row = rev(slot, log_n1) if natural else slot
                    if post is not None:
                        v = v * int(post[row, j0 + c]) % P
                    out[b, row, j0 + c] = v
                run_rounds(log_q, lambda k: T << (log_q - k), item, load,
                           store, work, S, tw, banks, f"cols Q={Q} T={T}")
    return out


def rows_kernel(x, dit, inverse, post, banks):
    """ntt_rows_kernel<dit> on x (B, n1, n2): DIT stores transposed in
    natural order, times post (n2, n1); DIF stores in slot order."""
    B, n1, N = x.shape
    log_n1, log_n2 = n1.bit_length() - 1, N.bit_length() - 1
    log_r = max(0, (ROW_TILE_WORDS >> log_n2).bit_length() - 1)
    if dit:
        log_r = max(log_r, 2)
    log_r = min(log_r, log_n1)
    R, S = 1 << log_r, line_words(N)
    tw = [int(t) for t in fft.twiddle_table(N, inverse)]
    flat = x.reshape(B * n1, N)
    out = np.zeros((B, N, n1) if dit else (B, n1, N), dtype=object)
    tag = f"rows N={N} R={R} {'DIT transposed' if dit else 'DIF'}"
    for g in range((B * n1) >> log_r):
        row0 = g << log_r
        b, k1_0 = row0 >> log_n1, row0 & (n1 - 1)
        work = [None] * (R * S)

        def item(w, s_lo, s_top):
            rest = w >> s_lo
            return (rest >> (log_n2 - s_top), w & ((1 << s_lo) - 1),
                    rest & ((1 << (log_n2 - s_top)) - 1))
        run_rounds(log_n2, lambda k: R << (log_n2 - k), item,
                   lambda line, p: int(flat[row0 + line, p]), None, work, S,
                   tw, banks, tag)
        E = R << log_n2
        for e0 in range(0, E, 32):
            addrs = []
            for e in range(e0, min(e0 + 32, E)):
                if dit:
                    line, k = e & (R - 1), e >> log_r
                    a = line * S + pad(rev(k, log_n2))
                    v = work[a]
                    if post is not None:
                        v = v * int(post[k, k1_0 + line]) % P
                    out[b, k, k1_0 + line] = v
                else:
                    line, k = e >> log_n2, e & (N - 1)
                    a = line * S + pad(k)
                    out[b, k1_0 + line, k] = work[a]
                addrs.append(a)
            banks.access(f"{tag} store", addrs)
    return out


def _check(name, got, want):
    if not (got.astype(np.uint64) == to_u64(want)).all():
        raise SystemExit(f"{name}: the emulated kernel differs")


def check_exact():
    rng = np.random.default_rng(0)
    banks = Banks()

    def rnd(shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    def tile(q, n1, n2):
        return nc.tile_cols(q, n1, n2).bit_length() - 1

    for n1, n2, inv in ((16, 32, False), (32, 8, True), (1, 4, False),
                        (64, 16, False)):
        a, pre, post = rnd((2, n1, n2)), rnd((n1, n2)), rnd((n1, n2))
        got = cols_kernel(a.astype(object), True, n1, n1.bit_length() - 1,
                          inv, pre, post, tile(n1, n1, n2), banks)
        _check(f"K3 n1={n1}", got, nc.ntt_cols(
            from_u64(a), inv, from_u64(pre), from_u64(post)))
    for q, r, n2 in ((16, 3, 8), (1, 3, 4), (2, 1, 16), (32, 2, 4)):
        a, pre, post = rnd((2, q, n2)), rnd((q, n2)), rnd((q << r, n2))
        got = cols_kernel(a.astype(object), True, q, (q << r).bit_length()
                          - 1, False, pre, post, tile(q, q << r, n2), banks)
        _check(f"K4 q={q} r={r}", got, nc.ntt_cols_zero_tail(
            from_u64(a), r, from_u64(pre), from_u64(post)))
    for q, tail, n2 in ((16, 0, 8), (4, 12, 4), (3, 13, 4), (0, 8, 2),
                        (128, 896, 4)):
        a, pre, post = rnd((2, q, n2)), rnd((q, n2)), rnd((q + tail, n2))
        n1 = q + tail
        got = cols_kernel(a.astype(object), False, q, n1.bit_length() - 1,
                          False, pre, post, tile(q, n1, n2), banks)
        _check(f"K5 q={q} tail={tail}", got, nc.ntt_cols_dif(
            from_u64(a), tail, from_u64(pre), from_u64(post)))
    for B, n1, N in ((2, 4, 16), (1, 8, 32), (3, 2, 1), (2, 16, 64),
                     (1, 4, 512)):
        a, post = rnd((B, n1, N)), rnd((N, n1))
        for inv in (False, True):
            _check(f"K3 rows n2={N}", rows_kernel(a, True, inv, post, banks),
                   nc.ntt_rows(from_u64(a), inv, from_u64(post)))
        _check(f"K5 rows n2={N}", rows_kernel(a, False, False, None, banks),
               nc.ntt_rows_dif(from_u64(a)))
    print("the emulated kernels equal the plain versions")


def main_path_banks():
    """One block of each form at the main paths' shapes (zero data: only
    the access pattern counts)."""
    banks = Banks()
    for Q, T, r in ((512, 16, 0), (1024, 8, 0), (128, 32, 3)):
        n1 = Q << r
        x = np.zeros((1, Q, T), dtype=object)
        cols_kernel(x, r == 0, Q, n1.bit_length() - 1, False, None, None,
                    T.bit_length() - 1, banks)
    for n1, N, dit in ((8, 512, True), (2, 2048, False), (4, 2048, True)):
        rows_kernel(np.zeros((1, n1, N), dtype=object), dit, False, None,
                    banks)
    for phase, deg in sorted(banks.report().items()):
        print(f"{phase}: {deg}")


if __name__ == "__main__":
    check_exact()
    main_path_banks()
