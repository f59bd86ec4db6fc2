"""The port's four-table EVM prover (plonky2_tpu_torch/evm/) against the
JAX package's, on the CPU.

- Keccak: keccak_f1600 and keccak256 equal the JAX package's.
- Trace generators: each table's ``generate_trace`` equals the JAX
  package's on the two sponge ops of tests/test_evm_all_stark.py; the
  vectorised keccak generator also on 5 permutations, whose padding
  permutation is cut short.
- CTLs: ``cross_table_lookup_data``'s Z polynomials and challenges equal
  the JAX package's.
- The quotient: each table's program (eval, permutation checks, CTL
  checks) through the plain version of K6 equals the JAX package's
  ``_compute_quotient_polys`` on the same leaves and challenges.
- The proof: ``prove_all`` under tests/test_stark.py:make_config equals
  the JAX package's field for field, its sha256 is pinned (chip_smoke.py
  holds the card's proof to it), the port's verifier accepts it and
  rejects a tampered copy, and dropping one logic flag breaks the CTLs
  (the mirror of tests/test_evm_all_stark.py).
Exact equality throughout."""
import copy
import json

import numpy as np
import pytest

from plonky2_tpu.evm import all_stark as jast
from plonky2_tpu.evm import cross_table_lookup as jctl
from plonky2_tpu.evm import prover as jprover
from plonky2_tpu.evm.keccak_stark import KeccakStark as JaxKeccakStark
from plonky2_tpu.hash import keccak as jkeccak
from plonky2_tpu.iop.challenger import Challenger as JaxChallenger
from plonky2_tpu_torch.evm import all_stark
from plonky2_tpu_torch.evm import keccak_sponge as sponge_mod
from plonky2_tpu_torch.evm.cross_table_lookup import (CrossTableLookupError,
                                                      cross_table_lookup_data,
                                                      ctl_zs_layout)
from plonky2_tpu_torch.evm.keccak_stark import KeccakStark
from plonky2_tpu_torch.evm.logic import IS_XOR
from plonky2_tpu_torch.evm.prover import prove_all
from plonky2_tpu_torch.evm.verifier import (EvmVerificationError,
                                             verify_all_proof)
from plonky2_tpu_torch.evm.workload import small_sponge_ops
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.fri.verifier import FriVerificationError
from plonky2_tpu_torch.hash import keccak
from plonky2_tpu_torch.iop.challenger import Challenger
from plonky2_tpu_torch.stark.permutation import compute_permutation_z_polys
from plonky2_tpu_torch.stark.quotient_program import (num_permutation_zs,
                                                      quotient_context,
                                                      quotient_scalars)
from plonky2_tpu_torch.utils.serialization import (proof_sha256,
                                                   proof_to_plain,
                                                   proof_words)
from tests.test_evm_all_stark import sponge_ops as jax_sponge_ops
from tests.test_stark import make_config as jax_make_config
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_stark import (P, lde_batch, make_config,
                                    one_thread, random_challenge_sets)

# sha256 of proof_words of prove_all(make_all_stark(), make_config(),
# generate_all_traces(small_sponge_ops())): the JAX package's proof too
SMALL_PROOF_SHA256 = ("9eca99ad915b77371d03b13fb57f0ec47f24adc58ac417c47"
                      "96b69e4faa13857")


@pytest.fixture(scope="module")
def traces():
    """(port traces, JAX traces) of the tests' two sponge ops."""
    ours = all_stark.generate_all_traces(small_sponge_ops())
    return ours, jast.generate_all_traces(jax_sponge_ops())


@pytest.fixture(scope="module")
def astark():
    """The port's four tables, their programs compiled once for the
    module."""
    stark = all_stark.make_all_stark()
    stark.programs(make_config())
    return stark


@pytest.fixture(scope="module")
def proofs(traces, astark):
    """(all_stark, config, port proof, JAX proof)."""
    ours, theirs = traces
    stark, config = astark, make_config()
    with one_thread():
        proof = prove_all(stark, config, ours, device="cpu")
    jproof = jprover.prove_all(jast.make_all_stark(), jax_make_config(),
                               theirs, use_device=False)
    return stark, config, proof, jproof


def test_keccak_equals_jax():
    rng = np.random.default_rng(7)
    for _ in range(3):
        state = [int(v) for v in rng.integers(0, 1 << 64, size=25,
                                              dtype=np.uint64)]
        assert keccak.keccak_f1600(state) == jkeccak.keccak_f1600(state)
    for n in (0, 1, 135, 136, 137, 300):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert keccak.keccak256(data) == jkeccak.keccak256(data)
    assert keccak.RC == jkeccak._RC


def test_trace_generators_equal_jax(traces):
    ours, theirs = traces
    assert [t.shape for t in ours] == [(2481, 128), (414, 8), (523, 16),
                                       (21, 256)]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    sponge = ours[all_stark.KECCAK_SPONGE]
    finals = np.flatnonzero(sponge[sponge_mod.IS_FINAL_BLOCK])
    assert [all_stark.KeccakSpongeStark().digest(sponge, int(j))
            for j in finals] == [keccak.keccak256(op.input)
                                 for op in small_sponge_ops()]


def test_keccak_generator_cuts_padding_like_jax():
    rng = np.random.default_rng(5)
    inputs = [[int(v) for v in rng.integers(0, 1 << 64, size=25,
                                            dtype=np.uint64)]
              for _ in range(5)]
    ours = KeccakStark().generate_trace(inputs)
    assert ours.shape == (KeccakStark.COLUMNS, 128)    # 120 rows + 8 cut
    np.testing.assert_array_equal(ours,
                                  JaxKeccakStark().generate_trace(inputs))


@pytest.fixture(scope="module")
def ctl_data(traces):
    """(port CTL data, challenges, JAX CTL data, challenges), each from a
    fresh transcript."""
    ours, theirs = traces
    config, jconfig = make_config(), jax_make_config()
    data, chs = cross_table_lookup_data(
        config, [from_u64(t) for t in ours],
        all_stark.all_cross_table_lookups(), Challenger())
    jdata, jchs = jctl.cross_table_lookup_data(
        jconfig, theirs, jast.all_cross_table_lookups(), JaxChallenger())
    return data, chs, jdata, jchs


def test_ctl_zs_equal_jax(ctl_data):
    data, chs, jdata, jchs = ctl_data
    assert [(c.beta, c.gamma) for c in chs.challenges] == \
        [(c.beta, c.gamma) for c in jchs.challenges]
    assert [len(d.zs_columns) for d in data] == [2, 284, 2, 2]
    for d, jd in zip(data, jdata):
        assert len(d.zs_columns) == len(jd.zs_columns)
        for z, jz in zip(d.zs_columns, jd.zs_columns):
            np.testing.assert_array_equal(to_u64(z.z), jz.z)


@pytest.mark.parametrize("table", range(4))
def test_table_quotient_program_equals_jax(traces, ctl_data, astark,
                                           table):
    ours, _ = traces
    config, jconfig = make_config(), jax_make_config()
    data, chs, jdata, _ = ctl_data
    jstark = jast.make_all_stark()
    stark = astark.starks[table]
    trace = ours[table]
    degree_bits = trace.shape[1].bit_length() - 1
    rng = np.random.default_rng(table)
    sets = jsets = None
    zs = []
    if stark.uses_permutation_args():
        sets, jsets = random_challenge_sets(
            rng, stark.permutation_batch_size(), config.num_challenges)
        zs.append(to_u64(compute_permutation_z_polys(
            stark, config, from_u64(trace), sets)))
    zs.append(np.stack([to_u64(z.z) for z in data[table].zs_columns]))
    alphas = [int(a) for a in rng.integers(0, P, size=2, dtype=np.uint64)]
    tb = lde_batch(trace, 1)
    zb = lde_batch(np.concatenate(zs), 1)
    want = jprover._compute_quotient_polys(
        jstark.starks[table], jconfig, tb, zb,
        num_permutation_zs(stark, config), jsets, jdata[table], alphas,
        degree_bits)
    prog = astark.programs(config)[table]
    assert len(ctl_zs_layout(astark.cross_table_lookups, table, 2)) == \
        len(data[table].zs_columns)
    ctx = quotient_context(stark, prog, degree_bits, 1, "cpu")
    got = ctx.compute(tb, zb, quotient_scalars(alphas, sets, chs.challenges))
    np.testing.assert_array_equal(to_u64(got).reshape(want.shape), want)


def test_all_proof_equals_jax(proofs):
    _, _, proof, jproof = proofs
    assert list(proof_words(proof)) == list(proof_words(jproof))
    assert proof_sha256(proof) == SMALL_PROOF_SHA256


def test_all_proof_reads_back_as_jax_classes(proofs):
    """scripts/jax_verify_evm_proof.py's reader rebuilds the JAX
    package's proof from the port's plain arrays."""
    from scripts.jax_verify_evm_proof import from_plain, jax_classes
    _, _, proof, jproof = proofs
    skeleton, arrays = proof_to_plain(proof)
    back = from_plain(json.loads(json.dumps(skeleton)), arrays,
                      jax_classes())
    assert type(back) is type(jproof)
    assert list(proof_words(back)) == list(proof_words(jproof))


def test_all_proof_verifies(proofs):
    stark, config, proof, _ = proofs
    verify_all_proof(stark, proof, config)


def test_all_proof_rejects_tampered_opening(proofs):
    stark, config, proof, _ = proofs
    bad = copy.deepcopy(proof)
    bad.stark_proofs[0].openings.local_values[3][0] ^= np.uint64(1)
    with pytest.raises((EvmVerificationError, FriVerificationError)):
        verify_all_proof(stark, bad, config)


def test_all_proof_rejects_mismatched_tables(traces):
    """Drop one logic row's XOR flag: the logic table's grand product no
    longer matches the sponge's, so the CTLs fail (the prover checks them
    before it commits anything past the traces)."""
    bad = [t.copy() for t in traces[0]]
    row = int(np.nonzero(bad[all_stark.LOGIC][IS_XOR])[0][0])
    bad[all_stark.LOGIC][IS_XOR, row] = 0
    with pytest.raises(CrossTableLookupError):
        cross_table_lookup_data(make_config(), [from_u64(t) for t in bad],
                                all_stark.all_cross_table_lookups(),
                                Challenger())
