"""Proof (de)serialization (the port's copy of
plonky2_tpu/utils/serialization.py), plain and compressed proofs
(plonk/compression.py), byte-compatible with the reference's
Buffer format (plonky2/src/util/serialization.rs:480-700): fields as
little-endian u64, hashes as 4 fields, Merkle proofs prefixed by their
length in one u8, structures concatenated with no other framing (the
shapes come from the CommonCircuitData).
"""
from __future__ import annotations

import struct

import numpy as np

from ..fri.proof import (SALT_SIZE, FriInitialTreeProof, FriProof,
                         FriQueryRound, FriQueryStep)
from ..hash.merkle import MerkleCap, MerkleProof
from ..plonk.proof import OpeningSet, Proof, ProofWithPublicInputs


class Buffer:
    def __init__(self, data: bytes = b""):
        self.data = bytearray(data)
        self.pos = 0

    def bytes(self) -> bytes:
        return bytes(self.data)

    # -- writing -----------------------------------------------------------

    def write_u8(self, x: int):
        self.data += struct.pack("<B", x)

    def write_u32(self, x: int):
        self.data += struct.pack("<I", x)

    def write_field(self, x):
        self.data += struct.pack("<Q", int(x))

    def write_field_ext(self, x):
        self.write_field_vec(np.asarray(x, dtype=np.uint64).reshape(2))

    def write_field_vec(self, v):
        self.data += np.asarray(v, dtype=np.uint64).reshape(-1).astype(
            "<u8").tobytes()

    def write_field_ext_vec(self, v):
        self.write_field_vec(np.asarray(v, dtype=np.uint64).reshape(-1, 2))

    def write_hash(self, h):
        self.write_field_vec(np.asarray(h, dtype=np.uint64).reshape(4))

    def write_merkle_cap(self, cap: MerkleCap):
        for h in cap.digests:
            self.write_hash(h)

    def write_merkle_proof(self, p: MerkleProof):
        if len(p.siblings) >= 256:
            raise ValueError(f"a Merkle proof of {len(p.siblings)} siblings")
        self.write_u8(len(p.siblings))
        for h in p.siblings:
            self.write_hash(h)

    def write_opening_set(self, os: OpeningSet):
        for v in (os.constants, os.plonk_sigmas, os.wires, os.plonk_zs,
                  os.plonk_zs_next, os.partial_products, os.quotient_polys):
            self.write_field_ext_vec(v)

    def write_fri_proof(self, fp: FriProof):
        for cap in fp.commit_phase_merkle_caps:
            self.write_merkle_cap(cap)
        for fqr in fp.query_round_proofs:
            for v, p in fqr.initial_trees_proof.evals_proofs:
                self.write_field_vec(v)
                self.write_merkle_proof(p)
            for step in fqr.steps:
                self.write_field_ext_vec(step.evals)
                self.write_merkle_proof(step.merkle_proof)
        self.write_field_ext_vec(fp.final_poly)
        self.write_field(fp.pow_witness)

    def write_proof(self, proof: Proof):
        self.write_merkle_cap(proof.wires_cap)
        self.write_merkle_cap(proof.plonk_zs_partial_products_cap)
        self.write_merkle_cap(proof.quotient_polys_cap)
        self.write_opening_set(proof.openings)
        self.write_fri_proof(proof.opening_proof)

    def write_proof_with_public_inputs(self, pwp: ProofWithPublicInputs):
        self.write_proof(pwp.proof)
        self.write_field_vec(np.array(pwp.public_inputs, dtype=np.uint64))

    # -- reading -----------------------------------------------------------

    def read_u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def read_u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.pos)[0]
        self.pos += 4
        return v

    def read_field(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.pos)[0]
        self.pos += 8
        return v

    def read_field_vec(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.data, dtype="<u8", count=n, offset=self.pos)
        self.pos += 8 * n
        return out.astype(np.uint64)

    def read_field_ext_vec(self, n: int) -> np.ndarray:
        return self.read_field_vec(2 * n).reshape(n, 2)

    def read_hash(self) -> np.ndarray:
        return self.read_field_vec(4)

    def read_merkle_cap(self, cap_height: int) -> MerkleCap:
        return MerkleCap(self.read_field_vec(4 << cap_height)
                         .reshape(1 << cap_height, 4))

    def read_merkle_proof(self) -> MerkleProof:
        n = self.read_u8()
        return MerkleProof([self.read_hash() for _ in range(n)])

    def read_opening_set(self, common) -> OpeningSet:
        cfg = common.config
        return OpeningSet(
            constants=self.read_field_ext_vec(common.num_constants),
            plonk_sigmas=self.read_field_ext_vec(cfg.num_routed_wires),
            wires=self.read_field_ext_vec(cfg.num_wires),
            plonk_zs=self.read_field_ext_vec(cfg.num_challenges),
            plonk_zs_next=self.read_field_ext_vec(cfg.num_challenges),
            partial_products=self.read_field_ext_vec(
                cfg.num_challenges * common.num_partial_products),
            quotient_polys=self.read_field_ext_vec(
                common.num_quotient_polys()))

    def read_initial_trees_proof(self, common) -> FriInitialTreeProof:
        # the constants-sigmas oracle is never salted
        salt = SALT_SIZE if common.fri_params.hiding else 0
        evals_proofs = []
        for n_polys in (common.num_preprocessed_polys(),
                        common.config.num_wires + salt,
                        common.num_zs_partial_products_polys() + salt,
                        common.num_quotient_polys() + salt):
            v = self.read_field_vec(n_polys)
            evals_proofs.append((v, self.read_merkle_proof()))
        return FriInitialTreeProof(evals_proofs)

    def read_fri_proof(self, common) -> FriProof:
        params = common.fri_params
        cfg = params.config
        caps = [self.read_merkle_cap(cfg.cap_height)
                for _ in params.reduction_arity_bits]
        rounds = []
        for _ in range(cfg.num_query_rounds):
            initial = self.read_initial_trees_proof(common)
            steps = []
            for arity_bits in params.reduction_arity_bits:
                evals = self.read_field_ext_vec(1 << arity_bits)
                steps.append(FriQueryStep(evals, self.read_merkle_proof()))
            rounds.append(FriQueryRound(initial, steps))
        final_poly = self.read_field_ext_vec(params.final_poly_len())
        pow_witness = self.read_field()
        return FriProof(caps, rounds, final_poly, pow_witness)

    def read_proof(self, common) -> Proof:
        cap_height = common.config.fri_config.cap_height
        return Proof(
            wires_cap=self.read_merkle_cap(cap_height),
            plonk_zs_partial_products_cap=self.read_merkle_cap(cap_height),
            quotient_polys_cap=self.read_merkle_cap(cap_height),
            openings=self.read_opening_set(common),
            opening_proof=self.read_fri_proof(common))

    def read_proof_with_public_inputs(self, common) -> ProofWithPublicInputs:
        proof = self.read_proof(common)
        pis = [int(x) for x in self.read_field_vec(common.num_public_inputs)]
        return ProofWithPublicInputs(proof, pis)


    # -- compressed proofs (reference serialization.rs:352-470, 694-760) ----

    def write_compressed_fri_proof(self, fp) -> None:
        for cap in fp.commit_phase_merkle_caps:
            self.write_merkle_cap(cap)
        qrp = fp.query_round_proofs
        for i in qrp.indices:
            self.write_u32(i)
        for idx in sorted(qrp.initial_trees_proofs):
            for v, p in qrp.initial_trees_proofs[idx].evals_proofs:
                self.write_field_vec(v)
                self.write_merkle_proof(p)
        for step_map in qrp.steps:
            for idx in sorted(step_map):
                self.write_field_ext_vec(step_map[idx].evals)
                self.write_merkle_proof(step_map[idx].merkle_proof)
        self.write_field_ext_vec(fp.final_poly)
        self.write_field(fp.pow_witness)

    def write_compressed_proof_with_public_inputs(self, cpwp) -> None:
        p = cpwp.proof
        self.write_merkle_cap(p.wires_cap)
        self.write_merkle_cap(p.plonk_zs_partial_products_cap)
        self.write_merkle_cap(p.quotient_polys_cap)
        self.write_opening_set(p.openings)
        self.write_compressed_fri_proof(p.opening_proof)
        self.write_field_vec(np.array(cpwp.public_inputs, dtype=np.uint64))

    def read_compressed_fri_proof(self, common):
        from ..plonk.compression import (CompressedFriProof,
                                         CompressedFriQueryRounds)
        params = common.fri_params
        cfg = params.config
        caps = [self.read_merkle_cap(cfg.cap_height)
                for _ in params.reduction_arity_bits]
        indices = [self.read_u32() for _ in range(cfg.num_query_rounds)]
        initial_trees_proofs = {
            idx: self.read_initial_trees_proof(common)
            for idx in sorted(set(indices))}
        steps = []
        cur_indices = list(indices)
        for arity_bits in params.reduction_arity_bits:
            cur_indices = [i >> arity_bits for i in cur_indices]
            step_map = {}
            for idx in sorted(set(cur_indices)):
                evals = self.read_field_ext_vec((1 << arity_bits) - 1)
                step_map[idx] = FriQueryStep(evals, self.read_merkle_proof())
            steps.append(step_map)
        final_poly = self.read_field_ext_vec(params.final_poly_len())
        pow_witness = self.read_field()
        return CompressedFriProof(
            commit_phase_merkle_caps=caps,
            query_round_proofs=CompressedFriQueryRounds(
                indices=indices, initial_trees_proofs=initial_trees_proofs,
                steps=steps),
            final_poly=final_poly, pow_witness=pow_witness)

    def read_compressed_proof_with_public_inputs(self, common):
        from ..plonk.compression import (CompressedProof,
                                         CompressedProofWithPublicInputs)
        cap_height = common.config.fri_config.cap_height
        proof = CompressedProof(
            wires_cap=self.read_merkle_cap(cap_height),
            plonk_zs_partial_products_cap=self.read_merkle_cap(cap_height),
            quotient_polys_cap=self.read_merkle_cap(cap_height),
            openings=self.read_opening_set(common),
            opening_proof=self.read_compressed_fri_proof(common))
        pis = [int(x) for x in self.read_field_vec(common.num_public_inputs)]
        return CompressedProofWithPublicInputs(proof, pis)


def serialize_proof(pwp: ProofWithPublicInputs) -> bytes:
    buf = Buffer()
    buf.write_proof_with_public_inputs(pwp)
    return buf.bytes()


def deserialize_proof(data: bytes, common) -> ProofWithPublicInputs:
    buf = Buffer(data)
    out = buf.read_proof_with_public_inputs(common)
    if buf.pos != len(buf.data):
        raise ValueError("trailing bytes in proof")
    return out


def serialize_compressed_proof(cpwp) -> bytes:
    buf = Buffer()
    buf.write_compressed_proof_with_public_inputs(cpwp)
    return buf.bytes()


def deserialize_compressed_proof(data: bytes, common):
    buf = Buffer(data)
    out = buf.read_compressed_proof_with_public_inputs(common)
    if buf.pos != len(buf.data):
        raise ValueError("trailing bytes in compressed proof")
    return out


def proof_to_plain(obj):
    """A proof's dataclass tree as (skeleton, arrays): the skeleton is
    JSON-ready (dataclasses as {"class", "fields"}, lists, tuples as
    {"tuple": [...]}, ints, None) and every numpy array is replaced by
    {"array": i}, an index into `arrays` (uint64).  Field names are the
    JAX package's, so a reader can rebuild its classes."""
    import dataclasses
    arrays = []

    def walk(x):
        if dataclasses.is_dataclass(x):
            return {"class": type(x).__name__,
                    "fields": {f.name: walk(getattr(x, f.name))
                               for f in dataclasses.fields(x)}}
        if isinstance(x, tuple):
            return {"tuple": [walk(v) for v in x]}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, np.ndarray):
            arrays.append(np.asarray(x, dtype=np.uint64))
            return {"array": len(arrays) - 1}
        if x is None:
            return None
        return int(x)

    return walk(obj), arrays


def proof_from_plain(skeleton, arrays, classes: dict):
    """proof_to_plain's inverse: the dataclass tree, each {"class"} built
    from `classes` (class name -> class)."""
    def walk(x):
        if isinstance(x, dict):
            if "class" in x:
                return classes[x["class"]](**{k: walk(v) for k, v in
                                              x["fields"].items()})
            if "tuple" in x:
                return tuple(walk(v) for v in x["tuple"])
            return arrays[x["array"]]
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x
    return walk(skeleton)


def proof_words(obj):
    """Every number of a proof's dataclass tree (lists, tuples, arrays,
    ints), in order; None fields are skipped."""
    import dataclasses
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from proof_words(getattr(obj, f.name))
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from proof_words(x)
    elif isinstance(obj, np.ndarray):
        yield from (int(v) for v in obj.reshape(-1))
    elif obj is not None:
        yield int(obj)


def proof_sha256(obj) -> str:
    """sha256 of ``proof_words`` as little-endian u64s."""
    import hashlib
    words = np.array(list(proof_words(obj)), dtype=np.uint64)
    return hashlib.sha256(words.astype("<u8").tobytes()).hexdigest()
