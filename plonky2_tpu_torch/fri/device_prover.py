"""The FRI opening proof on the device: composition, fold layers, proof of
work and query rounds.

The port's counterpart of the layered path of plonky2_tpu/fri/
device_prover.py (``device_composition``, ``_commit_body``, ``_fold_body``,
``device_fri_committed_trees``, ``_device_fri_proof_layered``,
``device_prove_openings``), with the same transcript and the same proof:

1. Composition.  For each opening batch b (points z_b, polynomials p_j,
   claimed values y_j) with alpha from the transcript,
       q_b(x) = (R_b(x) - R_b(z_b)) / (x - z_b),  R_b = sum_j alpha^j p_j,
   combined as F = (F * alpha^(k_b) + q_b) over the batches in order, then
   F'(x) = x F(x), in bit-reversed (leaf) order on the LDE coset, and its
   coefficients by a coset INTT (K3).  The JAX package reads R_b off the
   committed leaves, 2^rate_bits times as many points as coefficients; the
   port combines the commitments' coefficients instead and extends R_b to
   the coset in leaf order with K5, the same values since R_b is linear.
   1 / (x - z_b) is (x - z0 + z1 X) / norm with a base-field norm, and the
   norms of all points are inverted together (one Fermat inverse per
   column of ``INVERSE_ROWS`` rows, Montgomery's trick).
2. Fold layers.  Each layer commits the values in leaves of 2 * arity
   words (K1, then K2 level by level), observes the cap, draws beta, folds
   the coefficients (sum_i beta^i P_i, the JAX package's Horner sum, here a
   dot product with beta's powers) and evaluates them on the next coset in
   leaf order (K5).
3. The final polynomial's tail is asserted zero, its coefficients
   observed; the proof-of-work grind and the query rounds follow
   (fri/prover.py), with every tree's rows and paths prefetched in one
   gather per tree.

Steps 2-3 take one of two paths, chosen by ``device_fri_proof`` as the JAX
package's dispatcher chooses (plonky2_tpu/fri/device_prover.py:
device_fri_proof):

* fused (``_device_fri_proof_fused``, the JAX package's
  ``_device_fri_proof_fused``/``_fused_fri_fn``), for trees that live on
  the device, which every tree the port makes does: the transcript of the
  FRI part runs on the device (iop/challenger_torch.py:DeviceChallenger,
  kernel K9), so no layer waits for the host.  Each layer observes its cap
  and draws beta with beta's powers in one K9 launch, the fold multiplies
  by those powers on the device; the final polynomial is observed in one
  launch; the grind (K8) starts from the sponge's state and leaves its
  witness in the sponge, and one K9 launch observes it and draws the
  response and the query indices; the trees' rows and paths are gathered
  with those indices on the device; then one download brings everything
  to the host.  The host challenger replays the same observations (each
  layer's cap as soon as its copy arrives, while the card goes on) and
  the proof is refused unless the response is below its bound and the
  host's query indices equal the device's: the host transcript stays in
  step and the device's is checked word for word.
* layered (``_device_fri_proof_layered``): the host challenger draws each
  beta after the cap comes down, the host uploads beta's powers, and the
  grind (K8) starts from a state the host uploads.  It is the path of a
  non-algebraic hasher (the Keccak configuration), as in the JAX package:
  each layer's tree is hashed on the host (hash/merkle.py:MerkleTree),
  the transcript runs on the host with the hasher's permutation and the
  grind is the host's scalar one (fri/prover.py:host_pow_grind), while the
  folds and the layers' LDEs stay on the device.  For Poseidon the tests
  hold the fused path against it.

Both give the same proof.
"""
from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from ..field import extension as ext
from ..field import gf
from ..field import gf2
from ..field import goldilocks as gl
from ..field.convert import to_u64
from ..hash.hashers import POSEIDON_CONFIG
from ..hash.merkle import DeviceMerkleTree, merkle_tree
from ..iop.challenger_torch import DeviceChallenger
from ..ops import ntt
from ..ops.openings import CHUNK_ELEMS
from ..ops.partial_products import inverse_rows
from ..utils.bits import bit_reverse_indices
from ..utils.timing import NoopTiming
from .proof import FriProof
from .prover import fri_proof_of_work, fri_prover_query_rounds

INVERSE_ROWS = 8


@functools.lru_cache(maxsize=4)
def bitrev_perm(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(bit_reverse_indices(n)).to(device)


@functools.lru_cache(maxsize=4)
def xs_br(lde_bits: int, device: str) -> torch.Tensor:
    """The LDE coset's points shift * w^rev(j), in bit-reversed order."""
    n = 1 << lde_bits
    w = ntt.powers_table(gl.primitive_root_of_unity(lde_bits), n, device)
    return gf.mul(w[bitrev_perm(n, device)], gl.coset_shift())


def combine_coeffs(batch, oracles, apow, device) -> torch.Tensor:
    """(2, n) coefficients of R = sum_j apow[j] p_j over the batch's
    polynomials, read from the commitments' coefficients in chunks of rows
    (each chunk's products summed with one modsum)."""
    n = oracles[0].coeffs_dev.shape[-1]
    acc = torch.zeros((2, n), dtype=torch.int64, device=device)
    by_oracle = {}
    for j, info in enumerate(batch.polynomials):
        by_oracle.setdefault(info.oracle_index, []).append(
            (info.polynomial_index, j))
    rows = max(1, CHUNK_ELEMS // (2 * n))
    for o, pairs in by_oracle.items():
        coeffs = oracles[o].coeffs_dev
        idx = torch.tensor([p for p, _ in pairs], device=device)
        w = torch.stack(gf2.from_host([apow[j] for _, j in pairs], device), 1)
        for r in range(0, len(pairs), rows):
            part = coeffs.index_select(0, idx[r:r + rows])     # (R, n)
            prod = gf.mul(part[:, None, :], w[r:r + rows, :, None])
            acc = gf.add(acc, gf.modsum(prod, 0))
    return acc


def device_composition(instance, oracles, alpha, openings_batches,
                       lde_bits: int):
    """Returns (values in leaf order as an extension pair of (N,) tensors,
    coefficients (2, N)), N = 2^lde_bits.  `openings_batches` are the
    claimed values (FriOpenings.batches), which give R_b(z_b) on the host."""
    dev = oracles[0].coeffs_dev.device
    rate_bits = lde_bits - oracles[0].degree_log
    N = 1 << lde_bits
    xs = xs_br(lde_bits, str(dev))
    nb = len(instance.batches)
    r_vals, rbz, shifts = [], [], []
    for b, batch in enumerate(instance.batches):
        k = len(batch.polynomials)
        apow = ext.powers(alpha, k)
        acc = (0, 0)
        for a, y in zip(apow, openings_batches[b].values):
            acc = ext.s_add(acc, ext.s_mul(a, y))
        rbz.append(acc)
        shifts.append(ext.s_exp(alpha, k))
        r_vals.append(ntt.lde_coset_ntt_bitrev(
            combine_coeffs(batch, oracles, apow, dev), rate_bits))
    # x - z_b = (x - z0) - z1 X; 1 / (x - z_b) = ((x - z0) + z1 X) / norm
    dens = [(gf.sub(xs, gf.as_i64(b.point[0])),
             gf.neg(torch.full_like(xs, gf.as_i64(b.point[1]))))
            for b in instance.batches]
    norms = torch.stack([gf2.norm2(d) for d in dens])            # (nb, N)
    total = nb * N
    inv = inverse_rows(norms.reshape(min(INVERSE_ROWS, total), -1))
    inv = inv.reshape(nb, N)
    comp = (torch.zeros_like(xs), torch.zeros_like(xs))
    for b in range(nb):
        num = gf2.sub2((r_vals[b][0], r_vals[b][1]),
                       gf2.const2(rbz[b], xs))
        q = gf2.mul2(num, gf2.inverse2(dens[b], norm_inverse=inv[b]))
        comp = gf2.add2(gf2.mul2(comp, gf2.const2(shifts[b], xs)), q)
    comp = gf2.mul2_base(comp, xs)          # x F(x) (reference oracle.rs:1084)
    perm = bitrev_perm(N, str(dev))
    natural = torch.stack([comp[0][perm], comp[1][perm]])
    return comp, ntt.coset_intt(natural)


def commit_layer(values_br, arity: int, cap_height: int,
                 hasher=POSEIDON_CONFIG) -> DeviceMerkleTree:
    """Leaf j (column j of a (2 * arity, n / arity) matrix) holds values
    j * arity .. j * arity + arity - 1, each as its two coordinates."""
    c0, c1 = values_br
    m = c0.shape[0] // arity
    leaves = torch.stack([c0.reshape(m, arity), c1.reshape(m, arity)],
                         dim=-1).reshape(m, 2 * arity).T.contiguous()
    return merkle_tree(leaves, cap_height, hasher)


def fold_coeffs(coeffs: torch.Tensor, beta, arity: int) -> torch.Tensor:
    """(2, n) coefficients of P(x) = sum_i x^i P_i(x^arity) -> (2, n /
    arity) coefficients of sum_i beta^i P_i: the coordinates' products with
    beta's powers, summed over i.  `beta` is a host extension element, or
    its powers beta^0 .. beta^(arity - 1) as a (2, arity) tensor on the
    coefficients' device (K9 draws them so)."""
    m = coeffs.shape[1] // arity
    if isinstance(beta, torch.Tensor):
        bp = beta
    else:
        bp = torch.stack(gf2.from_host(ext.powers(beta, arity),
                                       coeffs.device))
    # s[c, d] = sum_i coeffs_c[:, i] * (beta^i)_d
    s = gf.modsum(gf.mul(coeffs.reshape(2, 1, m, arity),
                         bp.reshape(1, 2, 1, arity)), -1)
    return torch.stack([gf.add(s[0, 0], gf.mul(s[1, 1], gf2.W)),
                        gf.add(s[0, 1], s[1, 0])])


def device_fri_committed_trees(coeffs, values_br, challenger, fri_params,
                               timing=None, hasher=POSEIDON_CONFIG):
    """The commit phase: one tree per fold layer; returns (trees, final
    coefficients (final_len, 2) uint64)."""
    timing = timing if timing is not None else NoopTiming()
    trees: List[DeviceMerkleTree] = []
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    cap_height = fri_params.config.cap_height
    layers = fri_params.reduction_arity_bits
    for i, arity_bits in enumerate(layers):
        arity = 1 << arity_bits
        with timing.scope(f"layer {i} commit"):
            tree = commit_layer(values_br, arity, cap_height, hasher)
            challenger.observe_cap(tree.cap)
        trees.append(tree)
        beta = challenger.get_extension_challenge()
        shift = pow(shift, arity, gl.P)
        with timing.scope(f"layer {i} fold"):
            coeffs = fold_coeffs(coeffs, beta, arity)
            if i + 1 < len(layers):     # the last values are not committed
                values_br = tuple(ntt.lde_coset_ntt_bitrev(coeffs, 0, shift))
    host = to_u64(coeffs)
    final_len = host.shape[1] >> fri_params.config.rate_bits
    if np.any(host[:, final_len:]):
        raise RuntimeError("FRI final coefficients' tail is not zero")
    final = host.T[:final_len].copy()
    challenger.observe_extension_elements(final)
    return trees, final


def _device_fri_proof_layered(initial_trees, coeffs, values_br, challenger,
                              fri_params, timing=None,
                              hasher=POSEIDON_CONFIG) -> FriProof:
    timing = timing if timing is not None else NoopTiming()
    n = values_br[0].shape[0]
    trees, final = device_fri_committed_trees(coeffs, values_br, challenger,
                                              fri_params, timing, hasher)
    with timing.scope("proof of work"):
        pow_witness = fri_proof_of_work(challenger, fri_params.config,
                                        values_br[0].device, hasher)
    with timing.scope("queries"):
        indices = [int(c) % n for c in challenger.get_n_challenges(
            fri_params.config.num_query_rounds)]
        for t in initial_trees:
            t.prefetch(indices)
        xi = indices
        for tree, arity_bits in zip(trees, fri_params.reduction_arity_bits):
            xi = [x >> arity_bits for x in xi]
            tree.prefetch(xi)
        rounds = fri_prover_query_rounds(initial_trees, trees, indices,
                                         fri_params)
    return FriProof(commit_phase_merkle_caps=[t.cap for t in trees],
                    query_round_proofs=rounds, final_poly=final,
                    pow_witness=pow_witness)


class _HostCopy:
    """A device tensor's copy to the host, started without waiting; ``get``
    waits for this copy alone.  On the CPU the tensor itself."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cpu":
            self.host = t
            return
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().view(np.uint64).copy()


def _device_fri_proof_fused(initial_trees, coeffs, values_br, challenger,
                            fri_params, timing=None,
                            hasher=POSEIDON_CONFIG) -> FriProof:
    if not hasher.algebraic:
        raise ValueError("the fused FRI runs Poseidon's transcript on the "
                         f"device, not {hasher.name}'s")
    timing = timing if timing is not None else NoopTiming()
    cfg = fri_params.config
    layers = fri_params.reduction_arity_bits
    n = values_br[0].shape[0]
    nq = cfg.num_query_rounds
    dch = DeviceChallenger.from_host(challenger, coeffs.device)
    trees, cap_copies = [], []
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    with timing.scope("fri layers"):
        for i, arity_bits in enumerate(layers):
            arity = 1 << arity_bits
            tree = commit_layer(values_br, arity, cfg.cap_height)
            trees.append(tree)
            cap_copies.append(_HostCopy(tree.levels_dev[-1]))
            dch.observe_cap_array(tree.levels_dev[-1])
            _, powers = dch.get_extension_challenge(powers=arity)
            shift = pow(shift, arity, gl.P)
            coeffs = fold_coeffs(coeffs, powers, arity)
            if i + 1 < len(layers):     # the last values are not committed
                values_br = tuple(ntt.lde_coset_ntt_bitrev(coeffs, 0, shift))
        final_len = coeffs.shape[1] >> cfg.rate_bits
        dch.observe_extension_elements(coeffs[:, :final_len])
    with timing.scope("proof of work"):
        witness = dch.grind(cfg.proof_of_work_bits)
        draws, idx = dch.get_n_challenges(1 + nq, index_mask=n - 1)
    with timing.scope("queries"):
        queries = idx[1:]           # the draw before them is the response
        parts = [t.gather(queries) for t in initial_trees]
        x = queries
        for tree, arity_bits in zip(trees, layers):
            x = x >> arity_bits
            parts.append(tree.gather(x))
        head = [coeffs.reshape(-1), witness, draws, queries]
        sizes = [p.numel() for p in head + parts]
        download = _HostCopy(torch.cat([p.reshape(-1) for p in head + parts]))
    with timing.scope("host replay"):
        for tree, copy in zip(trees, cap_copies):
            tree.keep_cap(copy.get())
            challenger.observe_cap(tree.cap)
            challenger.get_extension_challenge()
        host = np.split(download.get(), np.cumsum(sizes)[:-1])
        last = host[0].reshape(2, -1)
        if last[:, final_len:].any():
            raise RuntimeError("FRI final coefficients' tail is not zero")
        final = last.T[:final_len].copy()
        challenger.observe_extension_elements(final)
        pow_witness = int(host[1][0])
        if pow_witness >= gl.P:
            raise RuntimeError("proof-of-work search found no witness")
        challenger.observe_element(pow_witness)
        response = challenger.get_challenge()
        if (response != int(host[2][0])
                or response >= 1 << (64 - cfg.proof_of_work_bits)):
            raise RuntimeError("the device's proof-of-work response differs "
                               "from the host's or is above its bound")
        indices = [int(c) % n for c in challenger.get_n_challenges(nq)]
        if indices != [int(i) for i in host[3]]:
            raise RuntimeError("the device's Fiat-Shamir transcript differs "
                               "from the host's")
        xi = indices
        for t, part in zip(initial_trees, host[4:]):
            t.store(xi, part.reshape(nq, -1))
        for tree, arity_bits, part in zip(trees, layers,
                                          host[4 + len(initial_trees):]):
            xi = [x >> arity_bits for x in xi]
            tree.store(xi, part.reshape(nq, -1))
        rounds = fri_prover_query_rounds(initial_trees, trees, indices,
                                         fri_params)
    return FriProof(commit_phase_merkle_caps=[t.cap for t in trees],
                    query_round_proofs=rounds, final_poly=final,
                    pow_witness=pow_witness)


def device_fri_proof(initial_trees, coeffs, values_br, challenger,
                     fri_params, timing=None,
                     hasher=POSEIDON_CONFIG) -> FriProof:
    """Steps 2-3 for the composition's values and coefficients: the fused
    path for an algebraic hasher whose initial trees live on the device
    (each of the port's does), else the layered one
    (plonky2_tpu/fri/device_prover.py:device_fri_proof)."""
    if hasher.algebraic and all(isinstance(t, DeviceMerkleTree)
                                for t in initial_trees):
        return _device_fri_proof_fused(initial_trees, coeffs, values_br,
                                       challenger, fri_params, timing,
                                       hasher)
    return _device_fri_proof_layered(initial_trees, coeffs, values_br,
                                     challenger, fri_params, timing, hasher)


def device_prove_openings(instance, oracles, fri_openings, challenger,
                          fri_params, timing=None,
                          hasher=POSEIDON_CONFIG) -> FriProof:
    """The opening proof of `oracles` (PolynomialBatch) for `instance`, with
    the claimed values `fri_openings` already observed; the fold layers'
    trees are the hasher's."""
    timing = timing if timing is not None else NoopTiming()
    alpha = challenger.get_extension_challenge()
    lde_bits = oracles[0].degree_log + fri_params.config.rate_bits
    with timing.scope("composition"):
        values_br, coeffs = device_composition(
            instance, oracles, alpha, fri_openings.batches, lde_bits)
    return device_fri_proof([o.merkle_tree for o in oracles], coeffs,
                            values_br, challenger, fri_params, timing, hasher)
