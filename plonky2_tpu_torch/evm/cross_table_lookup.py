"""Cross-table lookups: the filtered rows of "looking" tables form a
permutation of the filtered rows of a "looked" table, shown by grand
products of randomized column combinations.  The port's counterpart of
plonky2_tpu/evm/cross_table_lookup.py (reference
evm/src/cross_table_lookup.rs, evm/src/permutation.rs:54-112).

``cross_table_lookup_data`` computes the Z polynomials as torch ops where
the traces lie: each table's combined columns once, then per challenge
the randomized combination, the filter, and the inclusive running
product.  ``eval_cross_table_lookup_checks`` takes its challenges as
algebra values, so that the quotient's constraint program reads them as
scalar inputs."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..field import gf
from ..field import goldilocks as gl
from ..field.convert import from_u64, to_u64
from ..ops.partial_products import inclusive_prefix_product


class CrossTableLookupError(Exception):
    pass


@dataclass(frozen=True)
class GrandProductChallenge:
    beta: object
    gamma: object


@dataclass
class GrandProductChallengeSet:
    challenges: List[GrandProductChallenge]


def get_grand_product_challenge_set(challenger, num_challenges: int
                                    ) -> GrandProductChallengeSet:
    out = []
    for _ in range(num_challenges):
        beta = challenger.get_challenge()
        gamma = challenger.get_challenge()
        out.append(GrandProductChallenge(beta, gamma))
    return GrandProductChallengeSet(out)


class Column:
    """A linear combination of a table's columns plus a constant
    (reference cross_table_lookup.rs:27-142)."""

    def __init__(self, linear_combination: List[Tuple[int, int]],
                 constant: int = 0):
        self.linear_combination = list(linear_combination)
        self.constant = constant % gl.P

    @staticmethod
    def single(c: int) -> "Column":
        return Column([(c, 1)])

    @staticmethod
    def singles(cs) -> List["Column"]:
        return [Column.single(c) for c in cs]

    @staticmethod
    def constant_col(constant: int) -> "Column":
        return Column([], constant)

    @staticmethod
    def zero() -> "Column":
        return Column.constant_col(0)

    @staticmethod
    def le_bits(cs) -> "Column":
        return Column([(c, 1 << i) for i, c in enumerate(cs)])

    @staticmethod
    def le_bytes(cs) -> "Column":
        return Column([(c, pow(256, i, gl.P)) for i, c in enumerate(cs)])

    @staticmethod
    def sum_cols(cs) -> "Column":
        return Column([(c, 1) for c in cs])

    def eval_alg(self, alg, v):
        acc = alg.const(self.constant)
        for c, f in self.linear_combination:
            acc = alg.add(acc, alg.mul_const(v[c], f))
        return acc

@dataclass
class TableWithColumns:
    table: int                       # index into the table list
    columns: List[Column]
    filter_column: Optional[Column]


@dataclass
class CrossTableLookup:
    """The looking tables' filtered rows form a permutation of the looked
    table's (the JAX package's ``default`` padding rows are not ported:
    every lookup of the four tables filters its rows)."""
    looking_tables: List[TableWithColumns]
    looked_table: TableWithColumns

    def __post_init__(self):
        if any(len(t.columns) != len(self.looked_table.columns)
               for t in self.looking_tables):
            raise ValueError("looking and looked tables differ in width")


def ctl_zs_layout(cross_table_lookups, table: int,
                  num_challenges: int) -> list:
    """The CTL Z columns of `table` in prover order, each as (columns,
    filter column, index of its challenge): what the table's quotient
    program needs to know of them."""
    out = []
    for ctl in cross_table_lookups:
        for c in range(num_challenges):
            for twc in list(ctl.looking_tables) + [ctl.looked_table]:
                if twc.table == table:
                    out.append((twc.columns, twc.filter_column, c))
    return out


@dataclass
class CtlZData:
    z: torch.Tensor                  # (n,) grand-product values
    challenge: GrandProductChallenge
    columns: List[Column]
    filter_column: Optional[Column]


@dataclass
class CtlData:
    zs_columns: List[CtlZData] = field(default_factory=list)

    def z_polys(self) -> List[torch.Tensor]:
        return [zc.z for zc in self.zs_columns]


def eval_columns(trace: torch.Tensor, columns: List[Column]) -> torch.Tensor:
    """(len(columns), n): the values of many Columns of one table in one
    pass, where the trace lies.  Every term's product is split into 32-bit
    halves, summed per column exactly in int64 (``index_add_``), and
    reduced once, as ``gf.modsum`` does."""
    dev, n = trace.device, trace.shape[1]
    idx, coef, seg = [], [], []
    for j, col in enumerate(columns):
        for c, f in col.linear_combination:
            idx.append(c)
            coef.append(f % gl.P)
            seg.append(j)
    consts = from_u64(np.array([c.constant for c in columns],
                               dtype=np.uint64), dev)[:, None]
    if not idx:
        return consts.expand(len(columns), n).clone()
    vals = trace[torch.tensor(idx, device=dev)]
    coef = np.array(coef, dtype=np.uint64)
    if np.any(coef != 1):
        vals = gf.mul(vals, from_u64(coef, dev)[:, None])
    seg = torch.tensor(seg, device=dev)
    lo = torch.zeros((len(columns), n), dtype=torch.int64,
                     device=dev).index_add_(0, seg, vals & gf.M32)
    hi = torch.zeros_like(lo).index_add_(0, seg, gf.srl(vals, 32))
    low = lo + ((hi & gf.M32) << 32)
    total = gf.reduce128(low, gf.srl(hi, 32)
                         + gf.ult(low, lo).to(torch.int64))
    return gf.add(total, consts)


def _group_zs(trace: torch.Tensor, twcs: List[TableWithColumns],
              challenges: List[GrandProductChallenge]):
    """The Z polynomials of several lookups into one table, all
    challenges at once: (nch, G, n) running products of gamma + sum_i
    beta^i column_i over the rows whose filter is 1 (reference
    cross_table_lookup.rs:314-341), and the (F, n) filter values."""
    G, k, n = len(twcs), len(twcs[0].columns), trace.shape[1]
    vals = eval_columns(trace, [c for t in twcs for c in t.columns])
    vals = vals.reshape(G, k, n)
    with_filter = [g for g, t in enumerate(twcs)
                   if t.filter_column is not None]
    filt = torch.ones((G, n), dtype=torch.int64, device=trace.device)
    filters = filt[:0]
    if with_filter:
        filters = eval_columns(trace, [twcs[g].filter_column
                                       for g in with_filter])
        filt[with_filter] = filters
    accs = []
    for ch in challenges:
        w = from_u64(gl.powers(ch.beta, k), trace.device)
        acc = gf.modsum(gf.mul(vals, w[None, :, None]), 1)
        accs.append(gf.add(acc, torch.tensor(gf.as_i64(ch.gamma),
                                             device=trace.device)))
    acc = torch.stack(accs)
    acc = torch.where(filt[None] == 1, acc, torch.ones_like(acc))
    return inclusive_prefix_product(acc), filters


def cross_table_lookup_data(config, traces: List[torch.Tensor],
                            cross_table_lookups: List[CrossTableLookup],
                            challenger
                            ) -> Tuple[List[CtlData], GrandProductChallengeSet]:
    """(reference cross_table_lookup.rs:237-312).  The lookups of one CTL
    into one table go through together.  Raises CrossTableLookupError
    when a filter is not binary or the grand products do not match."""
    challenges = get_grand_product_challenge_set(challenger,
                                                 config.num_challenges)
    chs = challenges.challenges
    ctl_data_per_table = [CtlData() for _ in traces]
    filters, lasts = [], []
    for ctl in cross_table_lookups:
        twcs = list(ctl.looking_tables) + [ctl.looked_table]
        zs = [None] * len(twcs)                  # each: (nch, n)
        for table in dict.fromkeys(t.table for t in twcs):
            members = [i for i, t in enumerate(twcs) if t.table == table]
            group, f = _group_zs(traces[table], [twcs[i] for i in members],
                                 chs)
            filters.append(f)
            for g, i in enumerate(members):
                zs[i] = group[:, g]
        # per challenge: the looking products' last values, then the
        # looked one's
        lasts.append(torch.stack([z[:, -1] for z in zs], 1))
        for c, ch in enumerate(chs):
            for t, z in zip(twcs, zs):
                ctl_data_per_table[t.table].zs_columns.append(
                    CtlZData(z[c], ch, t.columns, t.filter_column))
    if not bool(torch.stack([((f == 0) | (f == 1)).all()
                             for f in filters]).all()):
        raise CrossTableLookupError("a CTL filter is not binary")
    for last in lasts:
        for row in to_u64(last).tolist():
            prod = 1
            for v in row[:-1]:
                prod = prod * v % gl.P
            if prod != row[-1]:
                raise CrossTableLookupError("CTL grand products don't "
                                            "match")
    return ctl_data_per_table, challenges


@dataclass
class CtlCheckVars:
    local_z: object
    next_z: object
    challenge: GrandProductChallenge
    columns: List[Column]
    filter_column: Optional[Column]


def ctl_check_vars_per_table(proofs, cross_table_lookups,
                             ctl_challenges: GrandProductChallengeSet,
                             nums_permutation_zs: List[int]
                             ) -> List[List[CtlCheckVars]]:
    """Each table's CTL Z openings in prover order, with int challenges
    (reference cross_table_lookup.rs:360-407)."""
    iters = []
    for p, num_perms in zip(proofs, nums_permutation_zs):
        zs = [(int(x[0]), int(x[1]))
              for x in p.openings.permutation_ctl_zs[num_perms:]]
        zs_next = [(int(x[0]), int(x[1]))
                   for x in p.openings.permutation_ctl_zs_next[num_perms:]]
        iters.append(iter(list(zip(zs, zs_next))))
    out = [[] for _ in proofs]
    for ctl in cross_table_lookups:
        for challenge in ctl_challenges.challenges:
            for t in list(ctl.looking_tables) + [ctl.looked_table]:
                z, z_next = next(iters[t.table])
                out[t.table].append(CtlCheckVars(z, z_next, challenge,
                                                 t.columns, t.filter_column))
    return out


def eval_cross_table_lookup_checks(alg, vars, ctl_vars: List[CtlCheckVars],
                                   consumer) -> None:
    """(reference cross_table_lookup.rs:410-451); each challenge's beta
    and gamma are algebra values."""
    one = alg.one()
    for lv in ctl_vars:
        beta, gamma = lv.challenge.beta, lv.challenge.gamma

        def combine(values):
            acc = None
            for c in reversed(lv.columns):
                e = c.eval_alg(alg, values)
                acc = e if acc is None else alg.add(alg.mul(acc, beta), e)
            return alg.add(acc, gamma)

        def filt(values):
            if lv.filter_column is not None:
                return lv.filter_column.eval_alg(alg, values)
            return one

        def select(f, x):
            return alg.add(alg.mul(f, x), alg.sub(one, f))

        local_filter = filt(vars.local_values)
        next_filter = filt(vars.next_values)
        consumer.constraint_first_row(
            alg.sub(lv.local_z,
                    select(local_filter, combine(vars.local_values))))
        consumer.constraint_transition(
            alg.sub(lv.next_z,
                    alg.mul(lv.local_z,
                            select(next_filter, combine(vars.next_values)))))


def verify_cross_table_lookups(cross_table_lookups, ctl_zs_lasts,
                               challenges: GrandProductChallengeSet,
                               config) -> None:
    """The grand products agree across tables (reference
    cross_table_lookup.rs:580-628)."""
    iters = [iter(v) for v in ctl_zs_lasts]
    for ctl in cross_table_lookups:
        for _ in challenges.challenges:
            prod_looking = 1
            for t in ctl.looking_tables:
                prod_looking = prod_looking * int(next(iters[t.table])) % gl.P
            if prod_looking != int(next(iters[ctl.looked_table.table])):
                raise CrossTableLookupError(
                    "Cross-table lookup verification failed.")
