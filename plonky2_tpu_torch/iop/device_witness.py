"""Witness generation on the device: the generator fixpoint as a fixed
schedule of batched waves over one slot buffer.

The port's counterpart of plonky2_tpu/iop/device_witness.py.  Which
generators fire in which wave depends only on the circuit and on the set
of input targets, not on their values.  So ``build_plan`` replays the
host engine's fixpoint (iop/generator.py) once on booleans, records the
waves, and uploads their index arrays; every proof then runs

    values <- zeros; values[inputs] <- the input values
    for each wave: cls.run_batch_device(meta, values, dep, out, err)
      (each maximal run of consecutive waves of a class with
      run_waves_device: cls.run_waves_device(values, dep, out, offsets,
      err), at once)
    wires  <- values[:degree * num_wires], fixed up at the copy classes

on the plan's device.  A run of PoseidonGate waves is one launch of kernel
K7 (hash/poseidon_cuda.py:poseidon_wires_waves_cuda) on a CUDA buffer (the
flagship's 18 in one); the other classes are a few torch operations.  On a
CPU buffer every wave runs its plain version.  The host uploads only the
input values and the random draws, and reads back only the public inputs
and the error flag.

Randomness: the dep-free scalar generators (RandomValueGenerator) draw
from the caller's ``rng`` each proof, one at a time, in generator order:
the host engine's first pass draws them in that order, so one
``random.Random(seed)`` gives both engines the same witness.

Conflicts: the host engine keeps the first write and raises when a later
one disagrees; the slot buffer keeps the last.  They can differ only where
a slot is written more than once, so ``_simulate_waves`` flags every such
rewrite (over an input, across waves, or twice inside one wave) and
``build_plan`` then refuses (returns None): the caller runs the host
engine, which raises if the values conflict.  A plan that builds is
conflict-free.  It also refuses a circuit with a generator class without
``run_batch_device`` or ``run_waves_device``, a scalar generator with
dependencies (or without one ``target``), 2^31 slots or more (int32
indices), or a fixpoint that stalls.
"""
from __future__ import annotations

import secrets
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..field.convert import from_u64, to_u64
from ..utils.timing import NoopTiming
from .generator import _get_cache, _ragged_arange
from .target import target_index


class _PlanMismatch(Exception):
    """The proof's input target set differs from the plan's."""


class _Wave:
    __slots__ = ("cls", "dep", "out", "meta")

    def __init__(self, cls, dep, out, meta):
        self.cls = cls
        self.dep = dep        # (n_deps, G) int32 slot indices
        self.out = out        # (n_outputs, G) int32 slot indices
        self.meta = meta      # int64 constants or None


class _WaveRun:
    """Consecutive waves of one class with run_waves_device: their index
    arrays side by side, wave v the columns [offsets[v], offsets[v + 1])."""
    __slots__ = ("cls", "dep", "out", "offsets")

    def __init__(self, cls, dep, out, offsets):
        self.cls, self.dep, self.out, self.offsets = cls, dep, out, offsets


def _group_runs(waves):
    """[(cls, dep, out, meta)] -> [(cls, dep, out, meta, offsets)]: each
    maximal run of consecutive waves of a class with run_waves_device as
    one item, its index arrays side by side (offsets None elsewhere)."""
    items = []
    for cls, dep, out, meta in waves:
        if not hasattr(cls, "run_waves_device"):
            items.append((cls, dep, out, meta, None))
            continue
        if not (items and items[-1][0] is cls and items[-1][4] is not None):
            items.append((cls, [], [], None, [0]))
        _, deps, outs, _, offsets = items[-1]
        deps.append(dep)
        outs.append(out)
        offsets.append(offsets[-1] + dep.shape[1])
    return [(cls, dep, out, meta, None) if offsets is None else
            (cls, np.concatenate(dep, 1), np.concatenate(out, 1), None,
             tuple(offsets))
            for cls, dep, out, meta, offsets in items]


class DeviceWitnessPlan:
    """One circuit's and one input target set's waves, on `device`."""

    def __init__(self, waves, n_slots, input_keys, input_idx, fix_pos,
                 fix_src, pi_idx, degree, num_wires, device,
                 prefix_gens=()):
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.device = device
        self.n_slots = n_slots
        self.input_keys = input_keys          # the inputs' targets, in order
        self.degree = degree
        self.num_wires = num_wires
        self._prefix_gens = list(prefix_gens)
        self._vals_cache_id: Optional[int] = None
        self._input_idx = up(input_idx)
        # the wires matrix is the slot buffer's prefix except at the
        # non-root members of copy classes (_gather_wires)
        self._fix_pos = up(fix_pos)
        self._fix_src = up(fix_src)
        self._pi_idx = up(pi_idx)
        # what run() launches: single waves, and runs (_WaveRun) whose
        # index arrays are uploaded once, side by side; self.waves keeps
        # every wave, a run's as views of its arrays
        self.steps, self.waves = [], []
        for cls, dep, out, meta, offsets in _group_runs(waves):
            if offsets is None:
                w = _Wave(cls, up(dep), up(out),
                          None if meta is None else from_u64(meta, device))
                self.steps.append(w)
                self.waves.append(w)
                continue
            run = _WaveRun(cls, up(dep), up(out), offsets)
            self.steps.append(run)
            self.waves += [_Wave(cls, run.dep[:, a:b], run.out[:, a:b], None)
                           for a, b in zip(offsets, offsets[1:])]

    def matches(self, inputs) -> bool:
        """Whether the PartialWitness `inputs` sets the plan's targets, in
        the plan's order (a dict seen before is not compared again)."""
        d = inputs.target_values
        if self._vals_cache_id == id(d) and len(d) == len(self.input_keys):
            return True
        if list(d.keys()) != self.input_keys:
            return False
        self._vals_cache_id = id(d)
        return True

    def _input_values(self, inputs) -> np.ndarray:
        if not self.matches(inputs):
            raise _PlanMismatch()
        d = inputs.target_values
        return np.fromiter(d.values(), dtype=np.uint64, count=len(d))

    def run(self, inputs, rng=None) -> Tuple[torch.Tensor, List[int]]:
        """inputs: a PartialWitness -> (the (num_wires, degree) int64 wires
        on the plan's device, the public inputs as ints).  ``rng`` draws
        the random wires (None: ``secrets``).  Raises ValueError if a
        Poseidon gate's swap wire is not 0 or 1, as the host engine does;
        _PlanMismatch if the input target set is not the plan's."""
        rng = secrets.SystemRandom() if rng is None else rng
        vals = self._input_values(inputs)
        if self._prefix_gens:
            buf: list = []
            for g in self._prefix_gens:
                g.run(None, buf, rng)
            vals = np.concatenate(
                [vals, np.array([v for _, v in buf], dtype=np.uint64)])
        values = torch.zeros(self.n_slots, dtype=torch.int64,
                             device=self.device)
        values[self._input_idx] = from_u64(vals, self.device)
        err = torch.zeros(1, dtype=torch.int32, device=self.device)
        for s in self.steps:
            if isinstance(s, _WaveRun):
                s.cls.run_waves_device(values, s.dep, s.out, s.offsets, err)
            else:
                s.cls.run_batch_device(s.meta, values, s.dep, s.out, err)
        # one copy to the host: the public inputs and the error flag
        tail = to_u64(torch.cat([values[self._pi_idx], err.long()]))
        if tail[-1]:
            raise ValueError("a Poseidon gate's swap wire is not 0 or 1")
        # the slot buffer (~0.5 GB at the flagship) is freed on return,
        # before the wires commitment
        return self._gather_wires(values), [int(x) for x in tail[:-1]]

    def _gather_wires(self, values: torch.Tensor) -> torch.Tensor:
        """The (num_wires, degree) wires from the slot buffer, which it
        overwrites.  The union-find's parent is the identity on
        class roots and singletons, and slot order is wire order (row-major
        row * num_wires + column, then the virtual targets), so the wires
        are the buffer's prefix, corrected only at the non-root members of
        copy classes."""
        wires = values[:self.degree * self.num_wires]
        wires[self._fix_pos] = values[self._fix_src]
        return wires.view(self.degree, self.num_wires).t().contiguous()


def _simulate_waves(cache, is_set, expired):
    """Boolean replay of generate_partial_witness's wave loop: (the
    [(group id, slots)] schedule, whether any slot is written more than
    once), or None if the fixpoint stalls.  `expired` marks the scalar
    generators the plan runs before the waves.  Sets stand as boolean
    masks, not np.unique: hash-based unique takes seconds on the flagship's
    million-slot waves."""
    n = expired.size
    remaining = n - int(expired.sum())
    pending = np.arange(n, dtype=np.int64)
    n_set = int(np.count_nonzero(is_set))
    waves = []
    rewrites = False
    while pending.size:
        mark = np.zeros(n, dtype=bool)
        mark[pending] = True
        pending = np.flatnonzero(mark & ~expired)       # sorted, distinct
        if not pending.size:
            break
        newly = []
        gids = cache.gid[pending]
        for gid in np.flatnonzero(np.bincount(gids,
                                              minlength=len(cache.groups))):
            group = cache.groups[gid]
            slots = cache.slot[pending[gids == gid]]
            dep_rows = group.dep_reps[slots]
            ready = (is_set[dep_rows].all(axis=1) if dep_rows.shape[1]
                     else np.ones(len(slots), dtype=bool))
            slots_r = np.sort(slots[ready])
            if not slots_r.size:
                continue
            flat = group.out_reps[slots_r].ravel()
            fresh = ~is_set[flat]
            is_set[flat] = True
            # every write lands on a slot of its own iff the set grows by
            # the writes' count
            grown = int(np.count_nonzero(is_set)) - n_set
            n_set += grown
            if grown != flat.size:
                rewrites = True
            if fresh.any():
                newly.append(flat[fresh])
            expired[group.gen_idx[slots_r]] = True
            remaining -= int(slots_r.size)
            waves.append((gid, slots_r))
        if not newly:
            break
        # the watchers of the slots set in this pass (a slot written twice
        # gives its watchers twice; the mark above takes each once)
        new_reps = np.concatenate(newly)
        starts = cache.w_indptr[new_reps]
        lens = cache.w_indptr[new_reps + 1] - starts
        nz = lens > 0
        if nz.any():
            offs = np.repeat(starts[nz], lens[nz]) + _ragged_arange(lens[nz])
            pending = cache.w_data[offs]
        else:
            pending = np.empty(0, dtype=np.int64)
    if remaining:
        return None
    return waves, rewrites


def build_plan(prover_data, common_data, inputs,
               device) -> Optional[DeviceWitnessPlan]:
    """The plan of this circuit (its ProverOnlyCircuitData and
    CommonCircuitData) for the input target set of the PartialWitness
    `inputs`, on `device`; None where the host engine must run (the
    module's docstring)."""
    generators = prover_data.generators
    cache = _get_cache(prover_data, common_data)
    num_wires = common_data.config.num_wires
    degree = common_data.degree()
    rep_arr = np.asarray(prover_data.representative_map, dtype=np.int64)
    # every representative and the whole wires prefix (_gather_wires)
    n_slots = max(int(rep_arr.max()) + 1 if rep_arr.size else 1,
                  degree * num_wires)
    if n_slots >= 1 << 31:
        return None
    if not all(hasattr(g.cls, "run_batch_device")
               or hasattr(g.cls, "run_waves_device") for g in cache.groups):
        return None

    # the scalar generators: only dep-free ones of one output `target`
    # (RandomValueGenerator), drawn on the host before the waves each
    # proof; their values join the input upload
    prefix_gens = [generators[gi] for gi in cache.scalar_idx]
    if any(g.dependencies() or not hasattr(g, "target")
           for g in prefix_gens):
        return None
    prefix_targets = [g.target for g in prefix_gens]

    def reps(targets):
        return np.fromiter((rep_arr[target_index(t, num_wires, degree)]
                            for t in targets), dtype=np.int32,
                           count=len(targets))

    input_keys = list(inputs.target_values.keys())
    input_idx = reps(input_keys + prefix_targets)

    is_set = np.zeros(n_slots, dtype=bool)
    is_set[input_idx] = True
    expired = np.zeros(len(generators), dtype=bool)
    expired[cache.scalar_idx] = True
    sim = _simulate_waves(cache, is_set, expired)
    if sim is None:
        return None
    schedule, rewrites = sim
    if rewrites:
        return None

    waves = []
    for gid, slots in schedule:
        group = cache.groups[gid]
        meta_fn = getattr(group.cls, "device_meta", None)
        meta = None if meta_fn is None else meta_fn(
            [generators[i] for i in group.gen_idx[slots]])
        waves.append((group.cls, group.dep_reps[slots].T.astype(np.int32),
                      group.out_reps[slots].T.astype(np.int32), meta))

    W = degree * num_wires
    wire_reps = rep_arr[:W]
    fix_pos = np.nonzero(wire_reps != np.arange(W))[0]
    return DeviceWitnessPlan(
        waves, n_slots, input_keys, input_idx, fix_pos.astype(np.int32),
        wire_reps[fix_pos].astype(np.int32),
        reps(list(prover_data.public_inputs)), degree, num_wires,
        torch.device(device), prefix_gens=prefix_gens)


def get_plan(prover_data, common_data, inputs, device, rebuild: bool = False,
             timing=None) -> Optional[DeviceWitnessPlan]:
    """The circuit's plan on `device`, built at the first call (under
    ``timing.scope("witness plan")``) and kept on its prover data, a
    refusal (None) included.  ``rebuild`` builds it
    anew, for a new input target set (plan.run raised _PlanMismatch)."""
    timing = timing if timing is not None else NoopTiming()
    plans = getattr(prover_data, "_device_witness_plans", None)
    if plans is None:
        plans = prover_data._device_witness_plans = {}
    key = str(torch.device(device))
    if key not in plans or rebuild:
        with timing.scope("witness plan"):
            plans[key] = build_plan(prover_data, common_data, inputs, device)
    return plans[key]
