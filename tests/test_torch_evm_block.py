"""The port's block path (plonky2_tpu_torch/evm/{rlp,mpt,transactions,
block}.py) against the JAX package's, on the CPU.

- The RLP, MPT, account and transaction helpers: the cases of
  tests/test_evm_block.py and tests/test_evm_transfer.py run against the
  port (tests/torch_evm_twins.py), and a seeded trie fuzz, RLP round trips,
  the MPT prover stream, sender recovery and ``apply_transactions`` give
  JAX's values.
- The reference transfer (tests/test_evm_transfer.py:TXN, upstream
  transfer_to_new_addr.rs; evm/workload.py:transfer_inputs builds its
  block as the JAX test does) with the sender taken as prover input: its
  six traces and public values equal JAX's, and the state root after the
  block is the hand-built trie's.
- Refusals on both packages: the insufficient balance panics (the JAX
  case runs in tests/test_evm_transfer.py); the block kernel's cases of
  tests/test_evm_binding.py (the sender recovered in the kernel and the
  roots, a tampered signature and a forged sender that panic, a tampered
  trie word that changes the computed root) run in both interpreters.
- ``heavy`` (RUN_HEAVY_TESTS=1): the same transfer in chip_smoke.py
  phase 9n's setting (in-kernel ecrecover, range check on): the six traces
  and public values equal JAX's.
Exact equality throughout."""
import random

import numpy as np
import pytest

import tests.test_evm_transfer as jtransfer
from plonky2_tpu.evm import block as jblock
from plonky2_tpu.evm import mpt as jmpt
from plonky2_tpu.evm import rlp as jrlp
from plonky2_tpu.evm import transactions as jtxns
from plonky2_tpu_torch.evm import block, mpt, rlp, transactions, workload
from tests.torch_evm_twins import ported

BLOCK_TESTS = ported("test_evm_block")
TRANSFER = ported("test_evm_transfer")
BINDING = ported("test_evm_binding")

HELPER_CASES = [
    (BLOCK_TESTS, "test_rlp_known_vectors"),
    (BLOCK_TESTS, "test_rlp_roundtrip"),
    (BLOCK_TESTS, "test_empty_trie_root_constant"),
    (BLOCK_TESTS, "test_single_leaf_trie_root"),
    (BLOCK_TESTS, "test_branch_with_inline_and_hashed_children"),
    (BLOCK_TESTS, "test_hex_prefix_encoding"),
    (BLOCK_TESTS, "test_mpt_prover_inputs_state_leaf"),
    (BLOCK_TESTS, "test_account_rlp_roundtrip"),
    (TRANSFER, "test_txn_decode_and_sender_recovery"),
]


@pytest.mark.parametrize("module,case", HELPER_CASES,
                         ids=[c for _, c in HELPER_CASES])
def test_helper_case(module, case):
    getattr(module, case)()


def _random_items(rng, n):
    """n (32-byte key, account RLP) pairs."""
    return [(rng.randbytes(32), mpt.AccountRlp(
        nonce=rng.getrandbits(rng.randint(0, 40)),
        balance=rng.getrandbits(rng.randint(0, 120))).encode())
        for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_trie_fuzz_equals_jax(seed):
    """tests/test_evm_block.py:test_trie_insert_fuzz, seeded, on both
    packages: lookups, insertion-order independence and equal roots and
    prover streams."""
    rng = random.Random(seed)
    for _ in range(5):
        items = _random_items(rng, rng.randint(1, 12))
        t, jt = mpt.PartialTrie.empty(), jmpt.PartialTrie.empty()
        for k, v in items:
            t = mpt.trie_insert(t, mpt.Nibbles.from_bytes(k), v)
            jt = jmpt.trie_insert(jt, jmpt.Nibbles.from_bytes(k), v)
        assert t.calc_hash() == jt.calc_hash()
        for k, v in items:
            assert mpt.trie_get(t, mpt.Nibbles.from_bytes(k)) == v
        t2 = mpt.PartialTrie.empty()
        for k, v in rng.sample(items, len(items)):
            t2 = mpt.trie_insert(t2, mpt.Nibbles.from_bytes(k), v)
        assert t2.calc_hash() == t.calc_hash()
        assert mpt.all_mpt_prover_inputs(block.TrieInputs(state_trie=t)) == \
            jmpt.all_mpt_prover_inputs(jblock.TrieInputs(state_trie=jt))


def test_rlp_equals_jax():
    rng = random.Random(5)
    for _ in range(50):
        item = [rng.randbytes(rng.randint(0, 70)) for _ in range(
            rng.randint(0, 6))] + [rlp.encode_int(rng.getrandbits(
                rng.randint(0, 256)))]
        enc = rlp.encode(item)
        assert enc == jrlp.encode(item)
        assert rlp.decode(enc) == jrlp.decode(enc)
    txns = [jtransfer.TXN, BINDING._sign_type0(
        BINDING.SK, nonce=0, gas_price=10, gas_limit=30_000,
        to=0xB0B0B0B0B0B0B0B0B0B0B0B0B0B0B0B0B0B0B0B0, value=123)]
    assert rlp.all_rlp_prover_inputs(txns) == jrlp.all_rlp_prover_inputs(
        txns)


def _port_inputs():
    inputs, after = workload.transfer_inputs()
    return inputs, after


def test_transfer_inputs_equal_jax():
    """evm/workload.py:transfer_inputs builds tests/test_evm_transfer.py's
    block and its hand-built trie after it."""
    inputs, after = workload.transfer_inputs()
    jinputs, jsender = jtransfer._inputs()
    assert inputs.signed_txns == jinputs.signed_txns == [jtransfer.TXN]
    assert inputs.tries.state_trie.calc_hash() == \
        jinputs.tries.state_trie.calc_hash()
    assert after.calc_hash() == \
        jtransfer._expected_state_after(jsender).calc_hash()
    assert (workload.TRANSFER_SENDER, workload.TRANSFER_TO,
            workload.TRANSFER_VALUE) == (jtransfer.SENDER, jtransfer.TO,
                                         jtransfer.VALUE)


def _jax_inputs():
    return jtransfer._inputs()


def test_transactions_equal_jax():
    (inputs, _), (jinputs, _) = _port_inputs(), _jax_inputs()
    txn, jtxn = (transactions.decode_type0_txn(jtransfer.TXN),
                 jtxns.decode_type0_txn(jtransfer.TXN))
    assert vars(txn) == vars(jtxn)
    assert transactions.recover_sender(txn) == jtxns.recover_sender(jtxn) \
        == jtransfer.SENDER
    assert transactions.intrinsic_gas(txn) == jtxns.intrinsic_gas(jtxn)
    got = transactions.apply_transactions(inputs.tries, inputs.signed_txns)
    want = jtxns.apply_transactions(jinputs.tries, jinputs.signed_txns)
    assert [t.calc_hash() for t in got[:3]] == \
        [t.calc_hash() for t in want[:3]]
    assert [vars(t) for t in got[3]] == [vars(t) for t in want[3]]
    assert got[4] == want[4]


def public_values(pv) -> tuple:
    return (vars(pv.trie_roots_before), vars(pv.trie_roots_after),
            vars(pv.block_metadata))


def _traces_equal(setting):
    (inputs, after), (jinputs, _) = _port_inputs(), _jax_inputs()
    traces, pv, kernel = block.generate_block_traces(inputs, **setting)
    jtraces, jpv, jkernel = jblock.generate_block_traces(jinputs, **setting)
    assert bytes(kernel.code) == bytes(jkernel.code)
    assert [t.shape for t in traces] == [t.shape for t in jtraces]
    for t, jt in zip(traces, jtraces):
        np.testing.assert_array_equal(t, jt)
    assert public_values(pv) == public_values(jpv)
    assert pv.trie_roots_after.state_root == after.calc_hash()
    return traces


def test_transfer_traces_equal_jax():
    traces = _traces_equal({"in_kernel_ecrecover": False})
    assert [t.shape for t in traces] == [
        (130, 1 << 18), (2481, 1 << 12), (414, 1 << 7), (523, 1 << 10),
        (21, 1 << 20), (92, 1 << 14)]


def test_transfer_insufficient_balance_panics():
    TRANSFER.test_transfer_insufficient_balance_panics()


@pytest.fixture(scope="module")
def binding_setup():
    return BINDING.setup._get_wrapped_function()()


@pytest.mark.parametrize("case", [
    "test_in_kernel_recovery_and_roots", "test_tampered_signature_panics",
    "test_forged_sender_witness_cannot_move_victim_funds",
    "test_trie_byte_tamper_changes_computed_root"])
def test_binding_case_on_both(binding_setup, case):
    getattr(BINDING, case)(binding_setup)


@pytest.mark.heavy
def test_transfer_traces_in_kernel_ecrecover_equal_jax():
    """chip_smoke.py phase 9n's setting: the sender recovered in the
    kernel and the arithmetic table's range check on."""
    traces = _traces_equal({"in_kernel_ecrecover": True,
                            "range_check": True})
    assert [t.shape for t in traces] == [
        (130, 1 << 19), (2481, 1 << 12), (414, 1 << 7), (523, 1 << 11),
        (21, 1 << 21), (237, 1 << 16)]
