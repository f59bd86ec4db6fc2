"""Witness generation on the host.

The port's copy of plonky2_tpu/iop/generator.py (reference
plonky2/src/iop/generator.rs:18-96): two executions of the same watch-list
fixpoint.

- ``generate_partial_witness``, the batched engine: each pass runs all the
  ready generators of a batchable class as one numpy evaluation
  (``run_batch``); readiness, writes, conflict checks and the watch lists
  are array operations.
- ``_generate_scalar``, the reference's queue, one generator at a time:
  the oracle the tests hold the engine against.

Batchable generator classes set ``batch_group`` and implement
``output_targets`` and the classmethod ``run_batch(gens, dep_vals)``.  A
class the device witness plan (iop/device_witness.py) can run also has the
classmethod ``run_batch_device(meta, values, dep, out, err)`` and, where
its generators carry constants, ``device_meta(gens)``, or, to run a run of
consecutive waves at once, ``run_waves_device(values, dep, out, offsets,
err)``.

Randomness is an argument: ``rng`` is any object with ``randrange(P)``
(``random.Random(seed)`` gives a reproducible witness) and None draws from
``secrets``.  The random generators run one at a time, in the engine's
order (the scalar generators of each pass, in ``pending`` order), so a
seeded stream gives the JAX package's witness under the same stream.
"""
from __future__ import annotations

import itertools
import secrets
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..field import goldilocks as gl
from .target import Target, target_index
from .witness import PartialWitness, PartitionWitness


class SimpleGenerator:
    """Runs once, when all its dependencies are set."""

    batch_group: Optional[str] = None     # set on batchable subclasses

    def dependencies(self) -> List[Target]:
        raise NotImplementedError

    def run_once(self, witness: PartitionWitness,
                 out: List[Tuple[Target, int]]) -> None:
        raise NotImplementedError

    def output_targets(self) -> List[Target]:
        raise NotImplementedError

    @classmethod
    def run_batch(cls, gens: List["SimpleGenerator"],
                  dep_vals: np.ndarray) -> np.ndarray:
        """dep_vals: (G, n_deps) uint64 -> (G, n_outputs) uint64."""
        raise NotImplementedError

    @classmethod
    def target_indices(cls, gens, num_wires: int,
                       degree: int) -> Tuple[np.ndarray, np.ndarray]:
        """The forest indices (iop/target.py:target_index) of the
        dependencies and outputs of G generators of this class, as
        (G, n_deps) and (G, n_outputs) int64; a class whose targets follow
        from a row computes them at once."""
        def rows(targets_of):
            t = [[target_index(x, num_wires, degree) for x in targets_of(g)]
                 for g in gens]
            return np.array(t, dtype=np.int64).reshape(len(gens), len(t[0]))
        return (rows(lambda g: g.dependencies()),
                rows(lambda g: g.output_targets()))

    # A device batch, where a class has one (iop/device_witness.py):
    #   device_meta(gens) -> numpy uint64 constants of the G generators,
    #     uploaded once with the plan (optional);
    #   run_batch_device(meta, values, dep, out, err) writes the wave in
    #     place: values is the plan's int64 slot buffer, dep (n_deps, G)
    #     and out (n_outputs, G) int32 slot indices, meta the uploaded
    #     constants (None without device_meta), err an int32 (1,) flag;
    #   or run_waves_device(values, dep, out, offsets, err): every maximal
    #     run of consecutive waves of the class at once, wave v the columns
    #     [offsets[v], offsets[v + 1]) of dep and out (no constants).

    def watch_list(self) -> List[Target]:
        return self.dependencies()

    def run(self, witness: PartitionWitness, out: List[Tuple[Target, int]],
            rng) -> bool:
        """Runs and returns True once the dependencies are set; ``rng``
        is the engine's (iop/generator.py's module docstring)."""
        if all(witness.contains(t) for t in self.dependencies()):
            self.run_once(witness, out)
            return True
        return False


class ConstantGenerator(SimpleGenerator):
    batch_group = "constant"

    def __init__(self, row: int, constant_index: int, wire_index: int,
                 constant: int):
        self.row = row
        self.constant_index = constant_index
        self.wire_index = wire_index
        self.constant = constant

    def dependencies(self):
        return []

    def output_targets(self):
        return [("w", self.row, self.wire_index)]

    @classmethod
    def run_batch(cls, gens, dep_vals):
        return np.array([g.constant for g in gens], dtype=np.uint64)[:, None]

    @classmethod
    def device_meta(cls, gens):
        return np.array([g.constant for g in gens], dtype=np.uint64)

    @classmethod
    def run_batch_device(cls, meta, values, dep, out, err):
        values[out[0]] = meta

    def run_once(self, witness, out):
        out.append((("w", self.row, self.wire_index), self.constant))


class CopyGenerator(SimpleGenerator):
    batch_group = "copy"

    def __init__(self, src: Target, dst: Target):
        self.src = src
        self.dst = dst

    def dependencies(self):
        return [self.src]

    def output_targets(self):
        return [self.dst]

    @classmethod
    def run_batch(cls, gens, dep_vals):
        return dep_vals

    @classmethod
    def run_batch_device(cls, meta, values, dep, out, err):
        values[out[0]] = values[dep[0]]

    def run_once(self, witness, out):
        out.append((self.dst, witness.get_target(self.src)))


class RandomValueGenerator(SimpleGenerator):
    """A uniform value from the engine's ``rng``; not batched, so the
    draws come one at a time in the engine's order."""

    def __init__(self, target: Target):
        self.target = target

    def dependencies(self):
        return []

    def run(self, witness, out, rng) -> bool:
        out.append((self.target, rng.randrange(gl.P)))
        return True


# -- the batched engine ----------------------------------------------------

class _Group:
    __slots__ = ("cls", "gen_idx", "dep_reps", "out_reps")

    def __init__(self, cls, gen_idx, dep_reps, out_reps):
        self.cls = cls
        self.gen_idx = gen_idx      # (G,) indices into the generators
        self.dep_reps = dep_reps    # (G, n_deps) representatives
        self.out_reps = out_reps    # (G, n_outs) representatives


class _GenCache:
    """A circuit's index structures for the engine, made once and kept on
    its prover data (a session proves many witnesses of one circuit)."""

    def __init__(self, generators, by_watches, rep_map, num_wires, degree):
        rep_arr = np.asarray(rep_map, dtype=np.int64)
        n = len(generators)

        # one group a batch group, in order of first appearance (a batch
        # group is one class, of one arity)
        grouped: Dict[str, list] = {}
        self.gid = np.full(n, -1, dtype=np.int32)   # generator -> group
        self.slot = np.zeros(n, dtype=np.int64)     # its index in the group
        scalars = []
        for i, g in enumerate(generators):
            bg = type(g).batch_group
            if bg is None:
                scalars.append(i)
            else:
                grouped.setdefault(bg, []).append(i)
        self.groups: List[_Group] = []
        for members in grouped.values():
            gidx = np.array(members, dtype=np.int64)
            cls = type(generators[members[0]])
            deps, outs = cls.target_indices([generators[i] for i in members],
                                            num_wires, degree)
            gid = len(self.groups)
            self.gid[gidx] = gid
            self.slot[gidx] = np.arange(len(members))
            self.groups.append(_Group(cls, gidx, rep_arr[deps],
                                      rep_arr[outs]))
        # the scalar generators, in index order
        self.scalar_idx = np.array(scalars, dtype=np.int64)

        # the watchers of each representative, as CSR (the lists laid out
        # in representative order)
        reps = np.fromiter(by_watches, dtype=np.int64, count=len(by_watches))
        lens = np.fromiter(map(len, by_watches.values()), dtype=np.int64,
                           count=len(by_watches))
        counts = np.zeros(len(rep_map) + 1, dtype=np.int64)
        counts[reps + 1] = lens
        self.w_indptr = np.cumsum(counts)
        data = np.fromiter(itertools.chain.from_iterable(
            by_watches.values()), dtype=np.int64, count=int(lens.sum()))
        order = np.argsort(reps, kind="stable")
        starts = np.cumsum(lens) - lens          # each list's place in data
        self.w_data = data[np.repeat(starts[order], lens[order])
                           + _ragged_arange(lens[order])] if lens.size \
            else data


def _get_cache(prover_data, common_data) -> _GenCache:
    cache = getattr(prover_data, "_gen_cache", None)
    if cache is None:
        cache = _GenCache(prover_data.generators,
                          prover_data.generator_indices_by_watches,
                          prover_data.representative_map,
                          common_data.config.num_wires, common_data.degree())
        prover_data._gen_cache = cache
    return cache


def _new_witness(inputs: PartialWitness, prover_data,
                 common_data) -> PartitionWitness:
    witness = PartitionWitness(common_data.config.num_wires,
                               common_data.degree(),
                               prover_data.representative_map)
    for t, v in inputs.target_values.items():
        witness.set_target_returning_rep(t, v)
    return witness


def generate_partial_witness(inputs: PartialWitness, prover_data,
                             common_data, rng=None) -> PartitionWitness:
    """Every generator's outputs from the caller's inputs; raises if a
    generator's write conflicts with a set value or if a generator never
    became ready."""
    rng = secrets.SystemRandom() if rng is None else rng
    generators = prover_data.generators
    cache = _get_cache(prover_data, common_data)
    witness = _new_witness(inputs, prover_data, common_data)

    values, is_set = witness.values, witness.is_set
    n = len(generators)
    expired = np.zeros(n, dtype=bool)
    remaining = n
    pending = np.arange(n, dtype=np.int64)
    buffer: List[Tuple[Target, int]] = []

    while pending.size:
        pending = np.unique(pending)
        pending = pending[~expired[pending]]
        if not pending.size:
            break
        newly: List[np.ndarray] = []
        gids = cache.gid[pending]

        for gid in np.unique(gids[gids >= 0]):
            group = cache.groups[gid]
            slots = cache.slot[pending[gids == gid]]
            dep_rows = group.dep_reps[slots]
            ready = (is_set[dep_rows].all(axis=1) if dep_rows.shape[1]
                     else np.ones(len(slots), dtype=bool))
            slots_all = slots[ready]
            if not slots_all.size:
                continue
            # big batches in chunks, so that the temporaries stay in cache
            chunk = getattr(group.cls, "batch_chunk", 0) or slots_all.size
            for c0 in range(0, slots_all.size, chunk):
                slots_r = slots_all[c0:c0 + chunk]
                dep_vals = values[group.dep_reps[slots_r]]
                gens_sub = [generators[i] for i in group.gen_idx[slots_r]]
                out_vals = np.asarray(
                    group.cls.run_batch(gens_sub, dep_vals), dtype=np.uint64)
                flat_r = group.out_reps[slots_r].ravel()
                flat_v = out_vals.ravel()
                already = is_set[flat_r]
                if already.any() and not np.array_equal(
                        values[flat_r[already]], flat_v[already]):
                    raise ValueError(
                        f"{group.cls.__name__}: batch write conflicts with "
                        "already-set partition values")
                fresh = ~already
                values[flat_r[fresh]] = flat_v[fresh]
                is_set[flat_r[fresh]] = True
                # duplicate writes inside one batch must agree
                if not np.array_equal(values[flat_r], flat_v):
                    raise ValueError(
                        f"{group.cls.__name__}: conflicting duplicate writes "
                        "in batch")
                if fresh.any():
                    newly.append(np.unique(flat_r[fresh]))
                expired[group.gen_idx[slots_r]] = True
            remaining -= int(slots_all.size)

        # the scalar generators, one at a time, in pending order
        for gi in pending[gids < 0]:
            if generators[gi].run(witness, buffer, rng):
                expired[gi] = True
                remaining -= 1
            news = []
            for t, v in buffer:
                rep = witness.set_target_returning_rep(t, v)
                if rep is not None:
                    news.append(rep)
            buffer.clear()
            if news:
                newly.append(np.array(news, dtype=np.int64))

        if not newly:
            break
        new_reps = np.unique(np.concatenate(newly))
        starts = cache.w_indptr[new_reps]
        lens = cache.w_indptr[new_reps + 1] - starts
        nz = lens > 0
        if nz.any():
            offs = np.repeat(starts[nz], lens[nz]) + _ragged_arange(lens[nz])
            pending = cache.w_data[offs]
        else:
            pending = np.empty(0, dtype=np.int64)

    if remaining:
        raise ValueError(f"{remaining} generators weren't run")
    return witness


def _ragged_arange(lens: np.ndarray) -> np.ndarray:
    """[0..lens[0]), [0..lens[1]), ... concatenated."""
    ends = np.cumsum(lens)
    out = np.arange(ends[-1], dtype=np.int64)
    out -= np.repeat(ends - lens, lens)
    return out


def _generate_scalar(inputs: PartialWitness, prover_data, common_data,
                     rng=None) -> PartitionWitness:
    """The reference's queue, one generator at a time
    (generator.rs:18-96)."""
    rng = secrets.SystemRandom() if rng is None else rng
    generators = prover_data.generators
    by_watches: Dict[int, List[int]] = prover_data.generator_indices_by_watches
    witness = _new_witness(inputs, prover_data, common_data)

    pending = list(range(len(generators)))
    expired = [False] * len(generators)
    remaining = len(generators)
    buffer: List[Tuple[Target, int]] = []

    while pending:
        next_pending: List[int] = []
        for gi in pending:
            if expired[gi]:
                continue
            if generators[gi].run(witness, buffer, rng):
                expired[gi] = True
                remaining -= 1
            for t, v in buffer:
                rep = witness.set_target_returning_rep(t, v)
                if rep is not None and rep in by_watches:
                    for wg in by_watches[rep]:
                        if not expired[wg]:
                            next_pending.append(wg)
            buffer.clear()
        pending = next_pending

    if remaining:
        raise ValueError(f"{remaining} generators weren't run")
    return witness
