"""The port's copy of plonky2_tpu/evm/block.py, with
``prove_block_traces`` (the proof of traces made once, on a device) split
out of ``prove_block``.

Block-level proof generation: GenerationInputs -> AllProof + PublicValues
(reference evm/src/generation/mod.rs + proof.rs:36-100).

The reference drives a ~40-file kernel asm library whose sources are absent
from its own tree here; this framework ships its OWN block kernel written in
the same asm DSL (kernel/).  The kernel:

1. builds POINTERED tries in `Segment::TrieData` from the sequential
   prover stream (mpt_asm.py load_all_mpts — reference mpt/load.asm,
   spec'd by cpu/kernel/tests/mpt/load.rs), leaving root pointers in
   `Segment::GlobalMetadata`;
2. COMPUTES all three before-roots in-kernel by RLP-encoding and
   keccak-hashing the loaded TrieData (mpt_asm.py mpt_hash_*_trie,
   KECCAK_GENERAL — reference mpt_hash.asm, spec'd by tests/mpt/hash.rs);
3. processes the signed transactions (txn_asm.py) — recovering each
   sender fully in-kernel by default (secp_asm.py ecrecover), moving
   balances and CREATING accounts through mpt_read/mpt_insert, and
   inserting each txn + receipt into their tries in-kernel — then
   REHASHES all three after-roots and halts (reference simulate_cpu halt
   loop, generation/mod.rs:119-136).  No trie root enters via
   PROVER_INPUT.

PublicValues (trie roots before/after + BlockMetadata) are read back from
the executed witness memory exactly like the reference
(generation/mod.rs:85-108) — so tampering with the executed memory state
breaks the memory table / CTLs, and the trie roots carried in the proof are
the ones the constrained execution produced.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import mpt as mpt_mod
from . import rlp as rlp_mod
from .kernel.assembler import Kernel, assemble
from .kernel.constants import evm_constants
from .kernel.parser import parse
from .mpt import PartialTrie


# --- global metadata slots (reference constants/global_metadata.rs) --------
class GlobalMetadata:
    LARGEST_CONTEXT = 0
    ORIGIN = 1
    MEMORY_SIZE = 2
    TRIE_DATA_SIZE = 3
    STATE_TRIE_ROOT = 4
    TRANSACTION_TRIE_ROOT = 5
    RECEIPT_TRIE_ROOT = 6
    STATE_TRIE_ROOT_DIGEST_BEFORE = 8
    TRANSACTION_TRIE_ROOT_DIGEST_BEFORE = 9
    RECEIPT_TRIE_ROOT_DIGEST_BEFORE = 10
    STATE_TRIE_ROOT_DIGEST_AFTER = 11
    TRANSACTION_TRIE_ROOT_DIGEST_AFTER = 12
    RECEIPT_TRIE_ROOT_DIGEST_AFTER = 13
    TRIE_ENCODED_CHILD_SIZE = 14


@dataclass
class TrieInputs:
    """reference generation/mod.rs:48-66."""
    state_trie: PartialTrie = field(default_factory=PartialTrie.empty)
    transactions_trie: PartialTrie = field(default_factory=PartialTrie.empty)
    receipts_trie: PartialTrie = field(default_factory=PartialTrie.empty)
    storage_tries: List[Tuple[int, PartialTrie]] = field(default_factory=list)


@dataclass
class BlockMetadata:
    """reference proof.rs:68-76."""
    block_beneficiary: int = 0      # 160-bit address
    block_timestamp: int = 0
    block_number: int = 0
    block_difficulty: int = 0
    block_gaslimit: int = 0
    block_chain_id: int = 0
    block_base_fee: int = 0


@dataclass
class GenerationInputs:
    """reference generation/mod.rs:33-46."""
    signed_txns: List[bytes] = field(default_factory=list)
    tries: TrieInputs = field(default_factory=TrieInputs)
    contract_code: Dict[int, bytes] = field(default_factory=dict)
    block_metadata: BlockMetadata = field(default_factory=BlockMetadata)


@dataclass
class TrieRoots:
    state_root: int = 0
    transactions_root: int = 0
    receipts_root: int = 0


@dataclass
class PublicValues:
    """reference proof.rs:36-50.

    ALL SIX roots are proof-bound: the kernel computes them by hashing
    the loaded (before) and mutated (after) pointered TrieData in-kernel
    through KECCAK_GENERAL (mpt_asm.py mpt_hash_*_trie), with the
    mutations themselves (balance moves, account creation, per-txn
    txn/receipt inserts) executed in-kernel via mpt_read/mpt_insert.
    Tampering with any trie byte changes an executed digest and breaks
    the memory/keccak CTLs; the host cross-checks in
    generate_block_traces are redundant sanity asserts, not the binding."""
    trie_roots_before: TrieRoots
    trie_roots_after: TrieRoots
    block_metadata: BlockMetadata


# ---------------------------------------------------------------------------
# prover-input dispatch (reference generation/prover_input.rs)
# ---------------------------------------------------------------------------

class BlockProverInputs:
    """Serves PROVER_INPUT(ns::fn) reads during kernel execution."""

    def __init__(self, inputs: GenerationInputs):
        from .transactions import apply_transactions
        self.inputs = inputs
        tries = inputs.tries
        self.roots_before = TrieRoots(
            state_root=tries.state_trie.calc_hash(),
            transactions_root=tries.transactions_trie.calc_hash(),
            receipts_root=tries.receipts_trie.calc_hash())
        (state_after, txn_after, rcpt_after,
         self.txns, self.senders) = apply_transactions(
            tries, inputs.signed_txns)
        self.tries_after = (state_after, txn_after, rcpt_after)
        self.roots_after = TrieRoots(
            state_root=state_after.calc_hash(),
            transactions_root=txn_after.calc_hash(),
            receipts_root=rcpt_after.calc_hash())
        self.mpt_data = mpt_mod.all_mpt_prover_inputs(tries)
        self.rlp_data = rlp_mod.all_rlp_prover_inputs(inputs.signed_txns)
        self._mpt_pos = 0
        self._rlp_pos = 0
        self._next_txn = 0

    def __call__(self, fn: Tuple[str, ...], state) -> int:
        ns = fn[0]
        if ns == "mpt":
            what = fn[1] if len(fn) > 1 else "load"
            if what == "load":
                v = self.mpt_data[self._mpt_pos]
                self._mpt_pos += 1
                return v
            # NO digest prover inputs exist anymore: all six trie roots
            # are computed in-kernel (mpt_asm.py mpt_hash_*_trie)
        if ns == "rlp":
            v = self.rlp_data[self._rlp_pos]
            self._rlp_pos += 1
            return v
        if ns == "end_of_txns":
            if self._next_txn == len(self.inputs.signed_txns):
                return 1
            self._next_txn += 1
            return 0
        if ns == "txn":
            if fn[1] == "sender":
                # host-side secp256k1 recovery (ecdsa/curve.py ecrecover);
                # prover-supplied until the in-kernel curve library lands
                return self.senders[self._next_txn - 1]
        if ns == "ff":
            # finite-field helpers (prover_input.rs:47-52,96-183)
            from ..field import goldilocks as gl  # noqa: F401
            fields = {
                "bn254_base": 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47,
                "secp256k1_base": 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
                "secp256k1_scalar": 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
            }
            n = fields[fn[1]]
            x = state.stack[-1]
            if fn[2] == "inverse":
                return pow(x, n - 2, n)
            if fn[2] == "sqrt":
                assert (n + 1) % 4 == 0
                return pow(x, (n + 1) // 4, n)
        if ns == "account_code":
            code = self.inputs.contract_code
            if fn[1] == "length":
                return len(code[state.stack[-1]])
            if fn[1] == "get":
                return code[state.stack[-3]][state.stack[-1]]
        raise ValueError(f"unrecognized prover input function {fn}")


# ---------------------------------------------------------------------------
# the block kernel
# ---------------------------------------------------------------------------

_BLOCK_KERNEL_ASM = """
%macro mstore_global(ix)
    // stack: value -> (empty); writes GlobalMetadata[$ix] in context 0
    PUSH $ix
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MSTORE_GENERAL
%endmacro

%macro mload_global(ix)
    // stack: (empty) -> value
    PUSH $ix
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MLOAD_GENERAL
%endmacro

GLOBAL main:
    // build the pointered tries in Segment::TrieData from the sequential
    // prover stream (mpt_asm.py load_all_mpts); root POINTERS land in
    // GlobalMetadata slots 4/5/6 and TrieDataSize in slot 3
    PUSH main_loaded
    PUSH load_all_mpts
    JUMP
main_loaded:
    // "before" trie roots -> global metadata slots 8..10, ALL computed
    // in-kernel from the loaded TrieData (KECCAK_GENERAL-bound)
    PUSH main_state_hashed
    PUSH mpt_hash_state_trie
    JUMP
main_state_hashed:
    %mstore_global(8)
    PUSH main_txn_hashed
    PUSH mpt_hash_txn_trie
    JUMP
main_txn_hashed:
    %mstore_global(9)
    PUSH main_rcpt_hashed
    PUSH mpt_hash_receipt_trie
    JUMP
main_rcpt_hashed:
    %mstore_global(10)

    // process signed transactions (type 0): parse RLP in-kernel, charge
    // intrinsic gas through CONSUME_GAS, move balances through
    // mpt_read/mpt_insert on the pointered state trie, and record the
    // txn + receipt into their tries in-kernel (txn_asm.py)
    PROVER_INPUT(end_of_txns)
    PUSH txns_done
    JUMPI
    // at least one txn: build the SHL/SHR shift table once (spliced here
    // by block_kernel(); no-txn blocks skip its ~2.8k cycles)
// SHIFT_TABLE_INIT_SPLICE
txn_first:
    PROVER_INPUT(rlp)           // txn byte length
    DUP1
    %mstore_global(17)          // current txn RLP length (txn_record)
    PUSH 0                      // i, len
rlp_copy:
    DUP2
    DUP2
    EQ
    PUSH rlp_copy_done
    JUMPI
    PROVER_INPUT(rlp)           // byte, i, len
    DUP2
    %stack (i, byte) -> (0, @SEGMENT_RLP_RAW, i, byte)
    MSTORE_GENERAL              // i, len
    PUSH 1
    ADD
    PUSH rlp_copy
    JUMP
rlp_copy_done:
    POP
    POP
    PUSH txn_parsed
    PUSH process_type_0_txn
    JUMP
txn_parsed:
    PUSH txn_gas_done
    PUSH buy_intrinsic_gas
    JUMP
txn_gas_done:
    // sender -> TXN_FIELD_ORIGIN: either full in-kernel ecrecover over
    // the re-encoded signing payload, or a prover-supplied witness
    // (block_kernel(in_kernel_ecrecover=...))
// SENDER_SPLICE
txn_sender_done:
    PUSH txn_xfer_done
    PUSH txn_transfer
    JUMP
txn_xfer_done:
    // record the txn + its receipt into their tries (in-kernel inserts)
    PUSH txn_recorded
    PUSH txn_record
    JUMP
txn_recorded:
txn_loop:
    PROVER_INPUT(end_of_txns)
    PUSH txns_done
    JUMPI
    PUSH txn_first
    JUMP
txns_done:
    // "after" trie roots -> global metadata slots 11..13, ALL rehashed
    // in-kernel from the mutated/extended TrieData — account creation,
    // txn-trie and receipt-trie growth included (mpt_insert)
    PUSH main_state_hashed2
    PUSH mpt_hash_state_trie
    JUMP
main_state_hashed2:
    %mstore_global(11)
    PUSH main_txn_hashed2
    PUSH mpt_hash_txn_trie
    JUMP
main_txn_hashed2:
    %mstore_global(12)
    PUSH main_rcpt_hashed2
    PUSH mpt_hash_receipt_trie
    JUMP
main_rcpt_hashed2:
    %mstore_global(13)

    PUSH halt_pc0
    JUMP

GLOBAL halt_pc0:
    PUSH halt_pc0
GLOBAL halt_pc1:
    JUMP
"""


_SENDER_IN_KERNEL = """
    PUSH txn_sender_done
    PUSH recover_sender
    JUMP
"""
_SENDER_PROVER_INPUT = """
    PROVER_INPUT(txn::sender)
    %mstore_txn_field(@TXN_FIELD_ORIGIN)
"""


def block_kernel(in_kernel_ecrecover: bool = True) -> Kernel:
    """Assemble the block kernel.

    ``in_kernel_ecrecover=True`` (the DEFAULT — soundness is opt-out, not
    opt-in) recovers every sender with the secp256k1 routine library
    (secp_asm.py) over the in-kernel signing hash — fully proof-bound,
    ~110k cycles per transaction (double-and-add scalar muls); False
    takes the sender as a PROVER_INPUT witness, for unit-scale tests that
    explicitly opt out.

    ALL SIX trie roots (state/txn/receipt, before and after) are computed
    in-kernel: load_all_mpts builds the pointered TrieData, the before
    roots hash it, transactions mutate it through mpt_read/mpt_insert
    (including account creation and the per-txn txn/receipt inserts), and
    the after roots rehash it.  No root enters via PROVER_INPUT."""
    from .kernel.asm_util import UTIL_ASM
    from .kernel.stdlib import SHIFT_TABLE_INIT
    from .mpt_asm import MPT_ASM
    from .secp_asm import SECP_ASM
    from .txn_asm import TXN_ASM, txn_field_constants

    consts = evm_constants()
    consts.update(txn_field_constants())
    # the shift table must exist before txn_asm's SHL/SHR run; its init
    # body falls through into the first txn's processing
    main_asm = _BLOCK_KERNEL_ASM.replace(
        "// SHIFT_TABLE_INIT_SPLICE\n", SHIFT_TABLE_INIT + "\n")
    main_asm = main_asm.replace(
        "// SENDER_SPLICE\n",
        _SENDER_IN_KERNEL if in_kernel_ecrecover else _SENDER_PROVER_INPUT)
    files = [parse(main_asm), parse(TXN_ASM), parse(UTIL_ASM),
             parse(MPT_ASM), parse(SECP_ASM)]
    return assemble(files, consts, optimize=False)


# ---------------------------------------------------------------------------
# trace generation + proving (reference generation/mod.rs:68-136)
# ---------------------------------------------------------------------------

def generate_block_traces(inputs: GenerationInputs, min_rows: int = 8,
                          range_check=None,
                          in_kernel_ecrecover: bool = True):
    """Returns (traces for the 6-table AllStark, PublicValues, kernel).

    ``range_check``: arithmetic-table 16-bit limb range check — None (auto
    at production heights), True, or False; see
    ``all_stark.arithmetic_range_check_policy``."""
    from .all_stark import generate_all_traces_with_cpu
    from .generation import generate_kernel_execution

    kernel = block_kernel(in_kernel_ecrecover=in_kernel_ecrecover)
    provider_factory = lambda: BlockProverInputs(inputs)  # noqa: E731
    ex = generate_kernel_execution(kernel, min_rows=min_rows,
                                   prover_input_factory=provider_factory)
    traces = generate_all_traces_with_cpu(kernel, min_rows=min_rows,
                                          execution=ex,
                                          range_check=range_check)

    from .memory import Segment
    mem = ex.final_state.memory

    def read_meta(ix: int) -> int:
        return mem.get((0, int(Segment.GlobalMetadata), ix), 0)

    # Sanity cross-check (redundant with the in-kernel binding): the
    # kernel-computed roots must equal an independent host recomputation.
    expected = TrieRoots(
        state_root=inputs.tries.state_trie.calc_hash(),
        transactions_root=inputs.tries.transactions_trie.calc_hash(),
        receipts_root=inputs.tries.receipts_trie.calc_hash())
    got = (read_meta(GlobalMetadata.STATE_TRIE_ROOT_DIGEST_BEFORE),
           read_meta(GlobalMetadata.TRANSACTION_TRIE_ROOT_DIGEST_BEFORE),
           read_meta(GlobalMetadata.RECEIPT_TRIE_ROOT_DIGEST_BEFORE))
    if got != (expected.state_root, expected.transactions_root,
               expected.receipts_root):
        raise ValueError(
            "kernel-loaded trie-root digests disagree with independently "
            f"recomputed roots: {got} vs {expected}")
    # after-roots: independently re-apply the transactions and compare
    from .transactions import apply_transactions
    state_after, txn_after, rcpt_after, _, _ = apply_transactions(
        inputs.tries, inputs.signed_txns)
    got_after = (read_meta(GlobalMetadata.STATE_TRIE_ROOT_DIGEST_AFTER),
                 read_meta(GlobalMetadata.TRANSACTION_TRIE_ROOT_DIGEST_AFTER),
                 read_meta(GlobalMetadata.RECEIPT_TRIE_ROOT_DIGEST_AFTER))
    if got_after != (state_after.calc_hash(), txn_after.calc_hash(),
                     rcpt_after.calc_hash()):
        raise ValueError(
            "kernel after-digests disagree with the re-applied "
            f"transactions: {got_after}")

    public_values = PublicValues(
        trie_roots_before=TrieRoots(
            read_meta(GlobalMetadata.STATE_TRIE_ROOT_DIGEST_BEFORE),
            read_meta(GlobalMetadata.TRANSACTION_TRIE_ROOT_DIGEST_BEFORE),
            read_meta(GlobalMetadata.RECEIPT_TRIE_ROOT_DIGEST_BEFORE)),
        trie_roots_after=TrieRoots(
            read_meta(GlobalMetadata.STATE_TRIE_ROOT_DIGEST_AFTER),
            read_meta(GlobalMetadata.TRANSACTION_TRIE_ROOT_DIGEST_AFTER),
            read_meta(GlobalMetadata.RECEIPT_TRIE_ROOT_DIGEST_AFTER)),
        block_metadata=inputs.block_metadata)
    return traces, public_values, kernel


def prove_block(inputs: GenerationInputs, config=None, min_rows: int = 8,
                range_check=None, in_kernel_ecrecover: bool = True,
                device=None, timing=None):
    """GenerationInputs -> (AllProof with PublicValues, AllStark)
    (reference prover.rs prove + generation/mod.rs generate_traces).

    ``range_check=None`` auto-enables the arithmetic table's 16-bit limb
    range check at production heights (>= 2^16 arithmetic rows).
    ``in_kernel_ecrecover`` defaults to True — every sender binds to its
    signature via the in-kernel secp256k1 recovery; unit-scale tests may
    opt OUT explicitly (see block_kernel).  The traces are made on the
    host; the proof runs on `device` (default cuda)."""
    traces, public_values, kernel = generate_block_traces(
        inputs, min_rows=min_rows, range_check=range_check,
        in_kernel_ecrecover=in_kernel_ecrecover)
    return prove_block_traces(traces, public_values, kernel, config,
                              device=device, timing=timing)


def prove_block_traces(traces, public_values, kernel, config=None,
                       device=None, timing=None, all_stark=None):
    """The six-table proof of ``generate_block_traces``'s output, under
    `config` (default standard_fast_config) on `device` (default cuda)
    through evm/prover.py:prove_all: (AllProof with PublicValues,
    AllStark).  ``all_stark``, where given, is the AllStark of an earlier
    call on the same kernel and trace widths, whose compiled quotient
    programs it keeps."""
    from ..stark.config import StarkConfig
    from .all_stark import make_all_stark_with_cpu
    from .arithmetic import NUM_ARITH_RC_COLUMNS
    from .prover import prove_all

    config = config if config is not None else \
        StarkConfig.standard_fast_config()
    # the flag follows the trace's width, so that the Stark cannot drift
    # from the witness
    rc = traces[-1].shape[0] == NUM_ARITH_RC_COLUMNS
    if all_stark is None:
        all_stark = make_all_stark_with_cpu(kernel, range_check=rc)
    elif (all_stark.starks[0].kernel is not kernel
          or all_stark.starks[-1].range_check != rc):
        raise ValueError("all_stark was made for another kernel or "
                         "arithmetic table")
    proof = prove_all(all_stark, config, traces, device=device,
                      timing=timing)
    proof.public_values = public_values
    return proof, all_stark
