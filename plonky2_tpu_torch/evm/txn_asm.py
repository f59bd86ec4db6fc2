"""The port's copy of plonky2_tpu/evm/txn_asm.py.

Kernel assembly for transaction processing: in-kernel RLP parsing of
type-0 signed transactions, intrinsic-gas purchase through CONSUME_GAS,
and the state-trie walk that debits/credits transfer balances inside
Segment::TrieData.

Reference correspondence: process_type_0_txn / process_normalized_txn /
intrinsic_gas live in the reference's kernel asm (sources absent from its
tree; behavior spec'd by cpu/kernel/tests/transaction_parsing/
parse_type_0_txn.rs and tests/core/intrinsic_gas.rs, mirrored by tests
here).  Sender recovery: `recover_sender` below re-encodes the signing
payload in-kernel (legacy / EIP-155), keccaks it through KECCAK_GENERAL
and runs the full secp256k1 `ecrecover` (secp_asm.py); the block kernel
can alternatively splice a PROVER_INPUT(txn::sender) witness for
unit-scale proofs (evm/block.py block_kernel in_kernel_ecrecover flag).

Stack convention: `routine(args..., retaddr)` with args above the return
address; routines exit by rearranging to (ret, outs...) and JUMPing.
"""

# TxnFields slot indices (reference constants/txn_fields.rs)
TXN_FIELDS = {
    "TXN_FIELD_CHAIN_ID_PRESENT": 0,
    "TXN_FIELD_CHAIN_ID": 1,
    "TXN_FIELD_NONCE": 2,
    "TXN_FIELD_MAX_PRIORITY_FEE_PER_GAS": 3,
    "TXN_FIELD_MAX_FEE_PER_GAS": 4,
    "TXN_FIELD_GAS_LIMIT": 5,
    "TXN_FIELD_TO": 6,
    "TXN_FIELD_VALUE": 7,
    "TXN_FIELD_DATA_LEN": 8,
    "TXN_FIELD_Y_PARITY": 9,
    "TXN_FIELD_R": 10,
    "TXN_FIELD_S": 11,
    "TXN_FIELD_ORIGIN": 12,
    # re-encoding the signing payload needs the original byte shape of
    # `to`: emptiness (contract creation) and the exact string length
    # (addresses carry leading zeros, so minimal re-encoding would be wrong)
    "TXN_FIELD_TO_PRESENT": 13,
    "TXN_FIELD_TO_LEN": 14,
}


def txn_field_constants() -> dict:
    from .mpt import EMPTY_CODE_HASH
    c = dict(TXN_FIELDS)
    c["GAS_TX"] = 21_000
    c["GAS_TXCREATE"] = 32_000
    c["EMPTY_CODE_HASH"] = EMPTY_CODE_HASH
    return c


TXN_ASM = """
// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

%macro rlp_read_byte
    // stack: pos -> byte, pos+1
    DUP1
    PUSH @SEGMENT_RLP_RAW
    PUSH 0
    MLOAD_GENERAL
    %stack (byte, pos) -> (1, pos, byte)
    ADD
    SWAP1
    // stack: byte, pos+1
%endmacro

%macro tload
    // stack: virt -> TrieData[virt]
    PUSH @SEGMENT_TRIE_DATA
    PUSH 0
    MLOAD_GENERAL
%endmacro

%macro tstore
    // stack: value, virt -> (empty); TrieData[virt] = value
    %stack (value, virt) -> (0, @SEGMENT_TRIE_DATA, virt, value)
    MSTORE_GENERAL
%endmacro

%macro mstore_txn_field(ix)
    // stack: value -> (empty)
    %stack (value) -> (0, @SEGMENT_TXN_FIELDS, $ix, value)
    MSTORE_GENERAL
%endmacro

%macro mload_txn_field(ix)
    // stack: (empty) -> value
    PUSH $ix
    PUSH @SEGMENT_TXN_FIELDS
    PUSH 0
    MLOAD_GENERAL
%endmacro

// ---------------------------------------------------------------------------
// RLP readers
// ---------------------------------------------------------------------------

// (pos, ret) -> (value, pos') — single byte or 0x80+len short string
GLOBAL rlp_read_scalar:
    %rlp_read_byte
    // stack: b, pos, ret
    DUP1
    PUSH 0x80
    GT                          // 0x80 > b: single-byte literal
    PUSH rrs_single
    JUMPI
    %stack (b, pos) -> (b, 0x80, pos)
    SUB                         // len, pos, ret
    %stack (len, pos) -> (len, 0, pos)
    // stack: len, acc, pos, ret
rrs_loop:
    DUP1
    ISZERO
    PUSH rrs_done
    JUMPI
    %stack (len, acc, pos) -> (pos, len, acc)
    %rlp_read_byte
    // stack: byte, pos, len, acc
    %stack (byte, pos, len, acc) -> (acc, 256, byte, len, pos)
    MUL
    ADD                         // acc' = acc*256 + byte
    // stack: acc, len, pos
    %stack (acc, len) -> (len, 1, acc)
    SUB
    // stack: len-1, acc, pos
    PUSH rrs_loop
    JUMP
rrs_done:
    // stack: 0, acc, pos, ret
    POP
    %stack (acc, pos, ret) -> (ret, acc, pos)
    JUMP
rrs_single:
    %stack (b, pos, ret) -> (ret, b, pos)
    JUMP

// (pos, ret) -> (value, len, pos') — like rlp_read_scalar but also
// returns the original string byte-length (needed to re-encode `to`
// faithfully: addresses carry leading zeros)
GLOBAL rlp_read_scalar_len:
    %rlp_read_byte
    // b, pos, ret
    DUP1
    PUSH 0x80
    GT
    PUSH rrsl_single
    JUMPI
    %stack (b, pos) -> (b, 0x80, pos)
    SUB
    // len, pos, ret
    DUP1
    %stack (len, len2, pos) -> (len, 0, pos, len2)
    // len, acc, pos, len0, ret
rrsl_loop:
    DUP1
    ISZERO
    PUSH rrsl_done
    JUMPI
    %stack (len, acc, pos) -> (pos, len, acc)
    %rlp_read_byte
    // byte, pos, len, acc, len0, ret
    %stack (byte, pos, len, acc) -> (acc, 256, byte, len, pos)
    MUL
    ADD
    %stack (acc, len) -> (len, 1, acc)
    SUB
    PUSH rrsl_loop
    JUMP
rrsl_done:
    POP
    %stack (acc, pos, len0, ret) -> (ret, acc, len0, pos)
    JUMP
rrsl_single:
    %stack (b, pos, ret) -> (ret, b, 1, pos)
    JUMP

// (pos, ret) -> (datalen, pos') — bytes written to Segment::TxnData[0..len)
GLOBAL rlp_read_data:
    %rlp_read_byte
    // stack: b, pos, ret
    DUP1
    PUSH 0x80
    GT
    PUSH rrd_single
    JUMPI
    %stack (b, pos) -> (b, 0x80, pos)
    SUB                         // len, pos, ret
    %stack (len, pos) -> (0, len, pos)
    // stack: i, len, pos, ret
rrd_loop:
    DUP2
    DUP2
    EQ
    PUSH rrd_done
    JUMPI
    %stack (i, len, pos) -> (pos, i, len)
    %rlp_read_byte
    // stack: byte, pos, i, len
    DUP3
    // stack: i, byte, pos, i, len
    %stack (i, byte) -> (0, @SEGMENT_TXN_DATA, i, byte)
    MSTORE_GENERAL
    // stack: pos, i, len
    %stack (pos, i, len) -> (1, i, len, pos)
    ADD
    %stack (i, len, pos) -> (i, len, pos)
    PUSH rrd_loop
    JUMP
rrd_done:
    // stack: i(==len), len, pos, ret
    POP
    %stack (len, pos, ret) -> (ret, len, pos)
    JUMP
rrd_single:
    // single data byte b < 0x80
    %stack (b, pos) -> (0, @SEGMENT_TXN_DATA, 0, b, 1, pos)
    MSTORE_GENERAL
    %stack (len, pos, ret) -> (ret, len, pos)
    JUMP

// ---------------------------------------------------------------------------
// type-0 transaction parsing (spec: parse_type_0_txn.rs)
// ---------------------------------------------------------------------------

// (ret) -> (); txn RLP expected at RlpRaw[0..]; fields land in TxnFields
GLOBAL process_type_0_txn:
    PUSH 0                      // pos
    %rlp_read_byte              // b, pos, ret
    DUP1
    PUSH 0xf7
    LT                          // 0xf7 < b: long list
    PUSH p0_long
    JUMPI
    POP                         // short list: header is one byte
    PUSH p0_fields
    JUMP
p0_long:
    %stack (b, pos) -> (b, 0xf7, pos)
    SUB                         // lenlen, pos
    ADD                         // pos += lenlen
p0_fields:
    // stack: pos, ret
    %stack (pos) -> (pos, p0_n)
    PUSH rlp_read_scalar
    JUMP
p0_n:
    %mstore_txn_field(@TXN_FIELD_NONCE)
    %stack (pos) -> (pos, p0_gp)
    PUSH rlp_read_scalar
    JUMP
p0_gp:
    DUP1
    %mstore_txn_field(@TXN_FIELD_MAX_PRIORITY_FEE_PER_GAS)
    %mstore_txn_field(@TXN_FIELD_MAX_FEE_PER_GAS)
    %stack (pos) -> (pos, p0_gas)
    PUSH rlp_read_scalar
    JUMP
p0_gas:
    %mstore_txn_field(@TXN_FIELD_GAS_LIMIT)
    %stack (pos) -> (pos, p0_to)
    PUSH rlp_read_scalar_len
    JUMP
p0_to:
    // value, len, pos, ret
    %mstore_txn_field(@TXN_FIELD_TO)
    DUP1
    %mstore_txn_field(@TXN_FIELD_TO_LEN)
    // to_present = (len != 0)
    ISZERO
    %stack (z) -> (1, z)
    SUB
    %mstore_txn_field(@TXN_FIELD_TO_PRESENT)
    %stack (pos) -> (pos, p0_value)
    PUSH rlp_read_scalar
    JUMP
p0_value:
    %mstore_txn_field(@TXN_FIELD_VALUE)
    %stack (pos) -> (pos, p0_data)
    PUSH rlp_read_data
    JUMP
p0_data:
    %mstore_txn_field(@TXN_FIELD_DATA_LEN)
    %stack (pos) -> (pos, p0_v)
    PUSH rlp_read_scalar
    JUMP
p0_v:
    // stack: v, pos, ret
    DUP1
    PUSH 34
    LT                          // 34 < v: EIP-155
    PUSH p0_eip155
    JUMPI
    %stack (v) -> (v, 27)
    SUB
    %mstore_txn_field(@TXN_FIELD_Y_PARITY)
    PUSH 0
    %mstore_txn_field(@TXN_FIELD_CHAIN_ID_PRESENT)
    PUSH 0
    %mstore_txn_field(@TXN_FIELD_CHAIN_ID)
    PUSH p0_rs
    JUMP
p0_eip155:
    // stack: v, pos, ret
    PUSH 1
    %mstore_txn_field(@TXN_FIELD_CHAIN_ID_PRESENT)
    %stack (v) -> (v, 35)
    SUB                         // d = v - 35, pos, ret
    DUP1
    %stack (d) -> (d, 2)
    MOD                         // d % 2, d, pos
    %mstore_txn_field(@TXN_FIELD_Y_PARITY)
    %stack (d) -> (d, 2)
    DIV                         // d / 2, pos
    %mstore_txn_field(@TXN_FIELD_CHAIN_ID)
p0_rs:
    // stack: pos, ret
    %stack (pos) -> (pos, p0_r)
    PUSH rlp_read_scalar
    JUMP
p0_r:
    %mstore_txn_field(@TXN_FIELD_R)
    %stack (pos) -> (pos, p0_s)
    PUSH rlp_read_scalar
    JUMP
p0_s:
    %mstore_txn_field(@TXN_FIELD_S)
    POP                         // pos
    // stack: ret — parsing/normalization complete
GLOBAL process_normalized_txn:
    JUMP

// ---------------------------------------------------------------------------
// intrinsic gas (spec: intrinsic_gas.rs): GAS_TX + data costs; charged
// through the constrained CONSUME_GAS instruction (the reference leaves
// Operation::ConsumeGas as todo!() — here it executes)
// ---------------------------------------------------------------------------

// (ret) -> ()
GLOBAL buy_intrinsic_gas:
    %mload_txn_field(@TXN_FIELD_DATA_LEN)
    %stack (len) -> (0, @GAS_TX, len)
    // stack: i, cost, len, ret
ig_loop:
    DUP3
    DUP2
    EQ
    PUSH ig_done
    JUMPI
    DUP1
    PUSH @SEGMENT_TXN_DATA
    PUSH 0
    MLOAD_GENERAL               // byte, i, cost, len
    ISZERO
    PUSH 12
    MUL                         // 12*is_zero, i, cost, len
    %stack (z12) -> (16, z12)
    SUB                         // 16 - 12*is_zero (16 nonzero / 4 zero)
    %stack (inc, i, cost) -> (inc, cost, i)
    ADD                         // cost', i, len
    SWAP1
    PUSH 1
    ADD                         // i+1, cost', len
    PUSH ig_loop
    JUMP
ig_done:
    // stack: i, cost, len, ret
    POP
    SWAP1
    POP                         // cost, ret
    // cumulative block gas for receipts: GlobalMetadata[15] += cost
    DUP1
    PUSH 15
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MLOAD_GENERAL
    ADD
    %stack (cum) -> (0, @SEGMENT_GLOBAL_METADATA, 15, cum)
    MSTORE_GENERAL
    CONSUME_GAS
    JUMP

// ---------------------------------------------------------------------------
// address -> state-trie key: keccak(addr), big-endian
// ---------------------------------------------------------------------------

// (addr, ret) -> (key)
GLOBAL addr_to_key:
    PUSH 0                      // i, addr, ret
a2k_loop:
    DUP1
    PUSH 20
    EQ
    PUSH a2k_hash
    JUMPI
    // byte = (addr >> 8*(19-i)) & 0xff
    %stack (i, addr) -> (19, i, i, addr)
    SUB                         // 19-i, i, addr
    PUSH 8
    MUL                         // sh, i, addr
    DUP3
    SWAP1                       // sh, addr, i, addr
    SHR                         // addr >> sh, i, addr
    PUSH 0xff
    AND                         // byte, i, addr
    DUP2
    %stack (i, byte) -> (0, @SEGMENT_KERNEL_GENERAL, i, byte)
    MSTORE_GENERAL              // i, addr
    PUSH 1
    ADD
    PUSH a2k_loop
    JUMP
a2k_hash:
    // stack: 20, addr, ret
    POP
    POP
    PUSH 20
    PUSH 0
    PUSH @SEGMENT_KERNEL_GENERAL
    PUSH 0
    KECCAK_GENERAL              // digest (little-endian u32-limb int), ret
    // byte-reverse the 32-byte digest -> big-endian trie key
    %stack (d) -> (0, 0, d)     // j, acc, d
a2k_rev:
    DUP1
    PUSH 32
    EQ
    PUSH a2k_done
    JUMPI
    %stack (j, acc, d) -> (d, 0xff, acc, j, d)
    AND                         // low, acc, j, d
    %stack (low, acc) -> (acc, 256, low)
    MUL
    ADD                         // acc' = acc*256 + low, j, d
    %stack (acc, j, d) -> (8, d, acc, j)
    SHR                         // d >> 8, acc, j
    %stack (d, acc, j) -> (1, j, acc, d)
    ADD                         // j+1, acc, d
    PUSH a2k_rev
    JUMP
a2k_done:
    // stack: 32, key, d, ret
    POP
    SWAP1
    POP                         // key, ret
    SWAP1
    JUMP

// ---------------------------------------------------------------------------
// the transfer itself — pointered-trie edition: accounts resolve through
// mpt_read on the state root POINTER (GlobalMetadata[4]); a missing
// recipient is CREATED in-kernel (fresh AccountRlp value + mpt_insert),
// so account-creating blocks stay fully proof-bound (reference
// tests/mpt/{read,insert}.rs semantics)
// ---------------------------------------------------------------------------

// (ret) -> (): debit Origin by Value, credit To (creating it if absent).
// TXN_FIELD_ORIGIN must already hold the sender — either recovered
// in-kernel (recover_sender below) or prover-supplied, per the block
// kernel's sender splice (evm/block.py block_kernel).
GLOBAL txn_transfer:
    %mload_txn_field(@TXN_FIELD_ORIGIN)
    %stack (origin) -> (origin, tt_skey)
    PUSH addr_to_key
    JUMP
tt_skey:
    // key, ret
    PUSH 4
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MLOAD_GENERAL
    // state_root_ptr, key, ret
    %stack (root, key) -> (root, 64, key, tt_sfound)
    PUSH mpt_read
    JUMP
tt_sfound:
    // vptr, ret
    DUP1
    ISZERO
    PUSH tt_panic
    JUMPI
    PUSH 1
    ADD                         // bal_ptr = vptr + 1
    DUP1
    %tload                      // bal, bal_ptr
    %mload_txn_field(@TXN_FIELD_VALUE)
    // value, bal, bal_ptr
    DUP2
    DUP2
    SWAP1                       // bal, value, value, bal, bal_ptr
    LT                          // bal < value ?, value, bal, bal_ptr
    PUSH tt_panic
    JUMPI
    %stack (value, bal) -> (bal, value)
    SUB                         // bal - value, bal_ptr
    %tstore
    // credit `to`, creating the account if absent
    %mload_txn_field(@TXN_FIELD_TO)
    %stack (to) -> (to, tt_tkey)
    PUSH addr_to_key
    JUMP
tt_tkey:
    // key, ret
    PUSH 4
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MLOAD_GENERAL
    %stack (root, key) -> (root, 64, key, tt_tfound, key)
    PUSH mpt_read
    JUMP
tt_tfound:
    // vptr, key, ret
    DUP1
    ISZERO
    PUSH tt_tabsent
    JUMPI
    PUSH 1
    ADD
    DUP1
    %tload
    %mload_txn_field(@TXN_FIELD_VALUE)
    ADD                         // bal + value, bal_ptr
    %tstore
    // key, ret
    POP
    JUMP
tt_tabsent:
    // vptr(=0), key, ret — create the account: fresh AccountRlp value
    // [nonce=0, balance=value, storage_ptr=0 (empty trie), code_hash=
    // keccak("")], then mpt_insert under the 64-nibble key
    POP
    %stack (key) -> (4, tt_talloc, key)
    PUSH mpt_alloc
    JUMP
tt_talloc:
    // nv, key, ret
    %mload_txn_field(@TXN_FIELD_VALUE)
    // value, nv, key, ret
    DUP2
    PUSH 1
    ADD
    SWAP1
    %tstore                     // TD[nv+1] = value (nonce/storage stay 0)
    PUSH @EMPTY_CODE_HASH
    DUP2
    PUSH 3
    ADD
    SWAP1
    %tstore                     // TD[nv+3] = keccak("")
    // nv, key, ret
    PUSH 4
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MLOAD_GENERAL
    // root, nv, key, ret
    %stack (root, nv, key) -> (root, 64, key, nv, tt_tinserted)
    PUSH mpt_insert
    JUMP
tt_tinserted:
    // new_root, ret
    %stack (nr) -> (0, @SEGMENT_GLOBAL_METADATA, 4, nr)
    MSTORE_GENERAL
    JUMP
tt_panic:
    PANIC

// ---------------------------------------------------------------------------
// per-transaction bookkeeping: insert the raw txn bytes into the
// transactions trie and the legacy receipt into the receipts trie, both
// in-kernel, so the after-roots of all three tries are facts of the
// constrained execution.  Key for index i = the nibbles of
// rlp.encode_int(i) — i's MINIMAL big-endian bytes (EMPTY for i = 0), so
// count = 2*bytelen(i) and packed = i itself.
// GlobalMetadata slots: 15 = cumulative gas, 16 = txn index,
// 17 = current txn's RLP byte length (set by the block kernel's loader).
// ---------------------------------------------------------------------------

%macro gm_load15(ix)
    PUSH $ix
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MLOAD_GENERAL
%endmacro

%macro gm_store15(ix)
    %stack (v) -> (0, @SEGMENT_GLOBAL_METADATA, $ix, v)
    MSTORE_GENERAL
%endmacro

// (ret) -> ()
GLOBAL txn_record:
    // key: count = 2 * bytelen(i), packed = i
    %gm_load15(16)
    DUP1
    %stack (i) -> (i, tr_klen)
    PUSH u256_bytelen
    JUMP
tr_klen:
    // blen, i, ret
    PUSH 2
    MUL
    // count, i, ret
    // --- txn value: [len, bytes...] copied from RlpRaw[0..len) ---
    %gm_load15(17)
    // vlen, count, i, ret
    DUP1
    PUSH 1
    ADD
    %stack (n) -> (n, tr_valloc)
    PUSH mpt_alloc
    JUMP
tr_valloc:
    // v, vlen, count, i, ret
    DUP1
    DUP3
    %tstore                     // TD[v] = vlen
    // v, vlen, count, i, ret
    DUP2
    DUP2
    PUSH 1
    ADD
    // v+1, vlen, v, vlen, count, i, ret
    %stack (dst, n) -> (@SEGMENT_TRIE_DATA, dst, @SEGMENT_RLP_RAW, 0, n, tr_vcopied)
    PUSH mem_copy
    JUMP
tr_vcopied:
    // v, vlen, count, i, ret
    SWAP1
    POP
    // v, count, i, ret
    PUSH 5
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MLOAD_GENERAL
    // txn_root, v, count, i, ret
    %stack (root, v, count, i) -> (root, count, i, v, tr_tinserted, count, i)
    PUSH mpt_insert
    JUMP
tr_tinserted:
    // new_txn_root, count, i, ret
    %gm_store15(5)
    // count, i, ret
    // --- receipt value: rlp([1, cum_gas, bloom(256 zero bytes), []]) ---
    // build at TrieEncodedChild[720..]: 0x01, rlp(cum), 0xb9 0x01 0x00,
    // 256 zero bytes, 0xc0; list-prefix backward from 720
    PUSH 0x01
    PUSH 720
    %stack (pos, one) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, pos, one)
    MSTORE_GENERAL
    %gm_load15(15)
    // cum, count, i, ret
    %stack (cum) -> (@SEGMENT_TRIE_ENCODED_CHILD, 721, cum, tr_rcum)
    PUSH rlp_write_scalar
    JUMP
tr_rcum:
    // a2, count, i, ret
    DUP1
    %stack (a2) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, a2, 0xb9)
    MSTORE_GENERAL
    DUP1
    PUSH 1
    ADD
    %stack (p) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, p, 0x01)
    MSTORE_GENERAL
    DUP1
    PUSH 2
    ADD
    %stack (p) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, p, 0x00)
    MSTORE_GENERAL
    // zero the 256 bloom bytes (scratch is dirty)
    DUP1
    PUSH 3
    ADD
    // z = a2+3, a2, count, i, ret
    DUP1
    PUSH 256
    ADD
    // zend, z, a2, count, i, ret
tr_bloom:
    DUP2
    DUP2
    EQ
    PUSH tr_bloomed
    JUMPI
    DUP2
    %stack (p) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, p, 0x00)
    MSTORE_GENERAL
    SWAP1
    PUSH 1
    ADD
    SWAP1
    PUSH tr_bloom
    JUMP
tr_bloomed:
    // zend, z, a2, count, i, ret
    SWAP1
    POP
    // zend, a2, count, i, ret
    DUP1
    %stack (p) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, p, 0xc0)
    MSTORE_GENERAL
    PUSH 1
    ADD
    // rend = zend+1, a2, count, i, ret
    SWAP1
    POP
    // rend, count, i, ret
    DUP1
    %stack (rend) -> (rend, 720)
    SUB
    // payload_len = rend - 720, rend, count, i, ret
    %stack (plen) -> (@SEGMENT_TRIE_ENCODED_CHILD, 720, plen, tr_rlp)
    PUSH rlp_write_list_prefix
    JUMP
tr_rlp:
    // hstart, rend, count, i, ret
    DUP2
    DUP2
    SWAP1
    SUB
    // rlen = rend - hstart, hstart, rend, count, i, ret
    DUP1
    PUSH 1
    ADD
    %stack (n) -> (n, tr_ralloc)
    PUSH mpt_alloc
    JUMP
tr_ralloc:
    // rv, rlen, hstart, rend, count, i, ret
    DUP1
    DUP3
    %tstore                     // TD[rv] = rlen
    // rv, rlen, hstart, rend, count, i, ret
    DUP1
    PUSH 1
    ADD
    // rv+1, rv, rlen, hstart, rend, count, i, ret
    %stack (dst, rv, rlen, hstart) -> (@SEGMENT_TRIE_DATA, dst, @SEGMENT_TRIE_ENCODED_CHILD, hstart, rlen, tr_rcopied, rv)
    PUSH mem_copy
    JUMP
tr_rcopied:
    // rv, rend, count, i, ret
    SWAP1
    POP
    // rv, count, i, ret
    PUSH 6
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MLOAD_GENERAL
    // rcpt_root, rv, count, i, ret
    %stack (root, rv, count, i) -> (root, count, i, rv, tr_rinserted, i)
    PUSH mpt_insert
    JUMP
tr_rinserted:
    // new_rcpt_root, i, ret
    %gm_store15(6)
    // i, ret — bump the txn index
    PUSH 1
    ADD
    %gm_store15(16)
    JUMP

// ---------------------------------------------------------------------------
// signing hash (legacy / EIP-155) + in-kernel sender recovery.  The RLP
// signing payload re-encodes from the parsed TxnFields + TxnData bytes
// into Segment::KernelGeneral (payload at offset 25, header reserve
// before it), is keccaked via KECCAK_GENERAL, and feeds ecrecover
// (secp_asm.py).  Canonical-scalar re-encoding reproduces the original
// bytes for consensus-valid transactions.
// ---------------------------------------------------------------------------

%macro sighash_scalar(fld)
    // (pos) -> (pos')
    %mload_txn_field($fld)
    %stack (v, pos) -> (@SEGMENT_KERNEL_GENERAL, pos, v, %%after)
    PUSH rlp_write_scalar
    JUMP
%%after:
%endmacro

// (ret) -> (z): big-endian keccak of the signing payload
GLOBAL compute_type0_sighash:
    PUSH 25
    %sighash_scalar(@TXN_FIELD_NONCE)
    %sighash_scalar(@TXN_FIELD_MAX_FEE_PER_GAS)
    %sighash_scalar(@TXN_FIELD_GAS_LIMIT)
    // `to`: absent -> 0x80; else the original-length byte string
    %mload_txn_field(@TXN_FIELD_TO_PRESENT)
    ISZERO
    PUSH sh_to_absent
    JUMPI
    %mload_txn_field(@TXN_FIELD_TO_LEN)
    // len, pos
    DUP1
    PUSH 1
    EQ
    PUSH sh_to_maybe_single
    JUMPI
sh_to_multi:
    DUP1
    %stack (len) -> (len, 0x80)
    ADD
    DUP3
    %stack (pos, hdr) -> (0, @SEGMENT_KERNEL_GENERAL, pos, hdr)
    MSTORE_GENERAL
    // len, pos
    %mload_txn_field(@TXN_FIELD_TO)
    // to, len, pos
    %stack (to, len, pos) -> (pos, 1, to, len, len, pos)
    ADD
    %stack (pos1, to, len) -> (@SEGMENT_KERNEL_GENERAL, to, pos1, len, sh_to_stored)
    PUSH store_be
    JUMP
sh_to_stored:
    // len, pos
    ADD
    %stack (x) -> (x, 1)
    ADD
    PUSH sh_value
    JUMP
sh_to_maybe_single:
    // len(=1), pos
    %mload_txn_field(@TXN_FIELD_TO)
    DUP1
    PUSH 0x80
    GT
    PUSH sh_to_single
    JUMPI
    POP
    PUSH sh_to_multi
    JUMP
sh_to_single:
    %stack (to, len, pos) -> (0, @SEGMENT_KERNEL_GENERAL, pos, to, pos)
    MSTORE_GENERAL
    %stack (pos) -> (pos, 1)
    ADD
    PUSH sh_value
    JUMP
sh_to_absent:
    DUP1
    %stack (pos) -> (0, @SEGMENT_KERNEL_GENERAL, pos, 0x80)
    MSTORE_GENERAL
    %stack (pos) -> (pos, 1)
    ADD
sh_value:
    %sighash_scalar(@TXN_FIELD_VALUE)
    // data: the raw bytes in Segment::TxnData[0..DATA_LEN)
    %mload_txn_field(@TXN_FIELD_DATA_LEN)
    // dlen, pos
    DUP1
    PUSH 1
    EQ
    PUSH sh_data_maybe_single
    JUMPI
sh_data_multi:
    // dlen is 0 or >= 2 here: prefix_fwd's short/long forms apply
    %stack (dlen, pos) -> (@SEGMENT_KERNEL_GENERAL, pos, dlen, sh_data_hdr, dlen)
    PUSH rlp_write_str_prefix_fwd
    JUMP
sh_data_hdr:
    // pos', dlen
    SWAP1
sh_data_copy:
    // dlen, pos
    %stack (dlen, pos) -> (@SEGMENT_KERNEL_GENERAL, pos, @SEGMENT_TXN_DATA, 0, dlen, sh_data_done, pos, dlen)
    PUSH mem_copy
    JUMP
sh_data_done:
    // pos, dlen
    ADD
    PUSH sh_chainid
    JUMP
sh_data_maybe_single:
    // a raw 1-byte string is verbatim only below 0x80 (unlike the RLP-item
    // payloads rlp_write_str_prefix_fwd wraps), so handle both cases here
    PUSH 0
    PUSH @SEGMENT_TXN_DATA
    PUSH 0
    MLOAD_GENERAL
    // b, dlen, pos
    DUP1
    PUSH 0x80
    GT
    PUSH sh_data_single
    JUMPI
    POP
    // dlen(=1), pos: header 0x81, then copy the byte
    DUP2
    %stack (pos) -> (0, @SEGMENT_KERNEL_GENERAL, pos, 0x81)
    MSTORE_GENERAL
    SWAP1
    %stack (pos) -> (pos, 1)
    ADD
    SWAP1
    PUSH sh_data_copy
    JUMP
sh_data_single:
    %stack (b, dlen, pos) -> (0, @SEGMENT_KERNEL_GENERAL, pos, b, pos)
    MSTORE_GENERAL
    %stack (pos) -> (pos, 1)
    ADD
sh_chainid:
    // pos
    %mload_txn_field(@TXN_FIELD_CHAIN_ID_PRESENT)
    ISZERO
    PUSH sh_finish
    JUMPI
    %sighash_scalar(@TXN_FIELD_CHAIN_ID)
    // EIP-155: two empty scalars close the payload
    DUP1
    %stack (pos) -> (0, @SEGMENT_KERNEL_GENERAL, pos, 0x80)
    MSTORE_GENERAL
    %stack (pos) -> (pos, 1)
    ADD
    DUP1
    %stack (pos) -> (0, @SEGMENT_KERNEL_GENERAL, pos, 0x80)
    MSTORE_GENERAL
    %stack (pos) -> (pos, 1)
    ADD
sh_finish:
    // pe, ret
    DUP1
    %stack (pe) -> (pe, 25)
    SUB
    // L, pe, ret
    %stack (l) -> (@SEGMENT_KERNEL_GENERAL, 25, l, sh_prefixed)
    PUSH rlp_write_list_prefix
    JUMP
sh_prefixed:
    // hstart, pe, ret
    DUP2
    DUP2
    SWAP1
    SUB
    // total = pe - hstart, hstart, pe, ret
    %stack (total, hstart, pe) -> (0, @SEGMENT_KERNEL_GENERAL, hstart, total)
    KECCAK_GENERAL
    %stack (z) -> (z, sh_swapped)
    PUSH u256_byteswap
    JUMP
sh_swapped:
    %stack (z, ret) -> (ret, z)
    JUMP

// (ret) -> (): recover the sender entirely in-kernel from the parsed
// signature and store it as TXN_FIELD_ORIGIN; an invalid signature can
// never reach the halt label (PANIC), so no proof exists for it
GLOBAL recover_sender:
    PUSH rs_hashed
    PUSH compute_type0_sighash
    JUMP
rs_hashed:
    // z, ret
    %mload_txn_field(@TXN_FIELD_Y_PARITY)
    %stack (p) -> (p, 27)
    ADD
    // v, z, ret
    %mload_txn_field(@TXN_FIELD_R)
    %mload_txn_field(@TXN_FIELD_S)
    // s, r, v, z, ret
    %stack (s, r, v, z) -> (z, v, r, s, rs_done)
    PUSH ecrecover
    JUMP
rs_done:
    // addr, ret
    DUP1
    PUSH @U256_MAX
    EQ
    PUSH rs_invalid
    JUMPI
    %mstore_txn_field(@TXN_FIELD_ORIGIN)
    JUMP
rs_invalid:
    PANIC
"""
