"""The port's copy of plonky2_tpu/evm/mpt_asm.py.

In-kernel Merkle-Patricia tries over a POINTER-BASED TrieData layout:
load, read, insert, and hash — so every trie root the proof announces
(before AND after, state AND transactions AND receipts) is a fact of the
constrained execution, and structural mutations (account creation, the
per-transaction txn/receipt inserts) happen in-kernel instead of through
PROVER_INPUT digests.

Reference correspondence (kernel asm sources are absent from the
reference tree; behavior is spec'd by its interpreter tests):

  - ``load_all_mpts``    — mpt/load.asm, spec cpu/kernel/tests/mpt/load.rs:
      consume the sequential prover-input stream
      (generation/mpt.rs:37-103 — mirrored by evm/mpt.py
      all_mpt_prover_inputs) and build pointered nodes in
      Segment::TrieData, leaving root POINTERS in
      GlobalMetadata::{State,Transaction,Receipt}TrieRoot (slots 4/5/6).
  - ``mpt_read``         — mpt/read.asm, spec tests/mpt/read.rs:
      (root_ptr, num_nibbles, key, ret) -> value_ptr (0 if absent).
  - ``mpt_insert``       — mpt/insert.asm, spec tests/mpt/insert.rs:
      (root_ptr, num_nibbles, key, value_ptr, ret) -> new_root_ptr, with
      eth_trie_utils::PartialTrie::insert semantics (the python oracle is
      evm/mpt.py trie_insert; inserting under a HASH node panics).
  - ``mpt_hash_*_trie``  — mpt/hash.asm, spec tests/mpt/hash.rs:
      yellow-paper appendix-D node encoding keccak'd through
      KECCAK_GENERAL, equal to ``PartialTrie.calc_hash()``.

Pointered node layout in Segment::TrieData (reference
constants/trie_type.rs type tags; pointer 0 is the canonical EMPTY node —
TrieData[0] is reserved and never written):

  HASH   p: [1, digest]
  BRANCH p: [2, child_ptr x16, value_ptr]      (value_ptr 0 = no value)
  EXT    p: [3, nibble_count, nibbles_packed, child_ptr]
  LEAF   p: [4, nibble_count, nibbles_packed, value_ptr]

Value layouts, selected by the schema global (TrieEncodedChildLen[0]):
  schema 0 (state):   v: [nonce, balance, storage_root_PTR, code_hash]
                      (matches the reference's mpt_read account layout,
                      tests/mpt/read.rs:38-45)
  schema 1 (storage): v: [x]
  schema 2 (bytes):   v: [len, byte x len]   (txn / receipt tries — the
                      leaf value bytes verbatim, so hashing them binds
                      the exact RLP the host trie hashed)

Scratch:
  - RLP node encodings build in Segment::TrieEncodedChild.  Each hashing
    recursion owns [rlp_pos+9, ...); children get scratch at the parent's
    append cursor (their result rides back on the stack); value payloads
    assemble at rlp_pos+600, beyond any node's own bytes (max node = 9
    header + 17 refs x 33 + hp < 600).
  - TrieEncodedChildLen[0] is the value-schema global;
    TrieEncodedChildLen[1..9] are ``mpt_insert``'s divergence-case locals
    (safe as FIXED slots: the divergence case allocates nodes but never
    recurses back into mpt_insert).

Byte extraction uses DIV/MOD only (bound to the arithmetic table by
ctl_arithmetic_div/_mod) — no shift table required, so loading/hashing/
reading may run before SHIFT_TABLE_INIT.
"""

MPT_ASM = """
// ---------------------------------------------------------------------------
// schema global (TrieEncodedChildLen[0]: 0 = state, 1 = storage, 2 = bytes)
// ---------------------------------------------------------------------------

%macro mpt_schema_load
    PUSH 0
    PUSH @SEGMENT_TRIE_ENCODED_CHILD_LEN
    PUSH 0
    MLOAD_GENERAL
%endmacro

%macro mpt_schema_store
    // (v) -> ()
    %stack (v) -> (0, @SEGMENT_TRIE_ENCODED_CHILD_LEN, 0, v)
    MSTORE_GENERAL
%endmacro

%macro tdload
    // (virt) -> (TrieData[virt])
    PUSH @SEGMENT_TRIE_DATA
    PUSH 0
    MLOAD_GENERAL
%endmacro

%macro tdstore
    // (virt, value) -> (); TrieData[virt] = value
    %stack (virt, value) -> (0, @SEGMENT_TRIE_DATA, virt, value)
    MSTORE_GENERAL
%endmacro

%macro gmload(ix)
    // () -> (GlobalMetadata[ix])
    PUSH $ix
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MLOAD_GENERAL
%endmacro

%macro gmstore(ix)
    // (v) -> ()
    %stack (v) -> (0, @SEGMENT_GLOBAL_METADATA, $ix, v)
    MSTORE_GENERAL
%endmacro

%macro add_const(c)
    // (x) -> (x + c)
    %stack (x) -> (x, $c)
    ADD
%endmacro

%macro sub_const(c)
    // (x) -> (x - c)
    %stack (x) -> (x, $c)
    SUB
%endmacro

// (X, p, ...) -> (p, ...); TrieData[p + c] = X
%macro tdstore_at(c)
    %stack (x, p) -> (p, $c, x, p)
    ADD
    %tdstore
%endmacro

// mpt_insert divergence-case locals (TrieEncodedChildLen[1..9])
%macro milocal_store(ix)
    // (v) -> ()
    %stack (v) -> (0, @SEGMENT_TRIE_ENCODED_CHILD_LEN, $ix, v)
    MSTORE_GENERAL
%endmacro

%macro milocal_load(ix)
    // () -> (v)
    PUSH $ix
    PUSH @SEGMENT_TRIE_ENCODED_CHILD_LEN
    PUSH 0
    MLOAD_GENERAL
%endmacro

// ---------------------------------------------------------------------------
// allocator: bump TrieDataSize (GlobalMetadata[3])
// ---------------------------------------------------------------------------

// (n, ret) -> (ptr)
GLOBAL mpt_alloc:
    %gmload(3)
    // p, n, ret
    DUP2
    DUP2
    ADD
    // p + n, p, n, ret
    %gmstore(3)
    %stack (p, n, ret) -> (ret, p)
    JUMP

// ---------------------------------------------------------------------------
// small numeric helpers (DIV/MOD only)
// ---------------------------------------------------------------------------

// (k, ret) -> (16^k)
GLOBAL pow16:
    PUSH 1
    // pw, k, ret
p16_loop:
    DUP2
    ISZERO
    PUSH p16_done
    JUMPI
    %stack (pw, k) -> (16, pw, k, 1)
    MUL
    // 16*pw, k, 1, ret
    SWAP2
    SWAP1
    SUB
    // k-1, 16*pw, ret
    SWAP1
    PUSH p16_loop
    JUMP
p16_done:
    %stack (pw, k, ret) -> (ret, pw)
    JUMP

// (cnt, key, ret) -> (nib, rem): first nibble of a cnt-nibble key and the
// remaining (cnt-1)-nibble suffix.  cnt must be >= 1.
GLOBAL nib_split:
    DUP1
    %sub_const(1)
    %stack (k1) -> (k1, ns_pw)
    PUSH pow16
    JUMP
ns_pw:
    // pw, cnt, key, ret
    %stack (pw, cnt, key) -> (key, pw, key, pw)
    DIV
    // nib = key / pw, key, pw, ret
    %stack (nib, key, pw) -> (key, pw, nib)
    MOD
    // rem = key % pw, nib, ret
    %stack (rem, nib, ret) -> (ret, nib, rem)
    JUMP

// (ncnt, npk, cnt, key, ret) -> (cp): length of the common nibble prefix
GLOBAL mpt_common_prefix:
    // m = min(ncnt, cnt)
    DUP3
    DUP2
    GT
    // ncnt > cnt ?, ncnt, npk, cnt, key, ret
    PUSH cpfx_use_cnt
    JUMPI
    DUP1
    PUSH cpfx_have_m
    JUMP
cpfx_use_cnt:
    DUP3
cpfx_have_m:
    // m, ncnt, npk, cnt, key, ret
    DUP1
    ISZERO
    PUSH cpfx_zero
    JUMPI
    DUP2
    %sub_const(1)
    %stack (e) -> (e, cpfx_pa)
    PUSH pow16
    JUMP
cpfx_pa:
    // pa, m, ncnt, npk, cnt, key, ret
    DUP5
    %sub_const(1)
    %stack (e) -> (e, cpfx_pb)
    PUSH pow16
    JUMP
cpfx_pb:
    // pb, pa, m, ncnt, npk, cnt, key, ret
    PUSH 0
    // cp, pb, pa, m, ncnt, npk, cnt, key, ret
cpfx_loop:
    DUP4
    DUP2
    EQ
    PUSH cpfx_done
    JUMPI
    // na = (npk / pa) % 16
    DUP6
    DUP4
    SWAP1
    // npk, pa, ...
    DIV
    PUSH 16
    SWAP1
    MOD
    // na, cp, pb, pa, m, ncnt, npk, cnt, key, ret
    // nb = (key / pb) % 16
    DUP9
    DUP4
    SWAP1
    DIV
    PUSH 16
    SWAP1
    MOD
    // nb, na, cp, pb, pa, m, ncnt, npk, cnt, key, ret
    EQ
    ISZERO
    PUSH cpfx_done
    JUMPI
    // cp += 1; pa /= 16; pb /= 16
    %add_const(1)
    %stack (cp, pb, pa) -> (pb, 16, pa, 16, cp)
    DIV
    // pb/16, pa, 16, cp, ...
    %stack (pbn, pa, sixteen, cp) -> (pa, sixteen, pbn, cp)
    DIV
    // pa/16, pb/16, cp, ...
    %stack (pan, pbn, cp) -> (cp, pbn, pan)
    PUSH cpfx_loop
    JUMP
cpfx_done:
    %stack (cp, pb, pa, m, ncnt, npk, cnt, key, ret) -> (ret, cp)
    JUMP
cpfx_zero:
    %stack (m, ncnt, npk, cnt, key, ret) -> (ret, 0)
    JUMP

// ---------------------------------------------------------------------------
// load_all_mpts — consume the sequential prover-input stream and build
// pointered nodes (reference mpt/load.asm, spec tests/mpt/load.rs)
// ---------------------------------------------------------------------------

// (ret) -> ()
GLOBAL load_all_mpts:
    // TrieData[0] is the reserved EMPTY node; allocation starts at 1
    PUSH 1
    %gmstore(3)
    PUSH 0
    %mpt_schema_store
    PUSH lam_state
    PUSH mpt_load_node
    JUMP
lam_state:
    // state_root_ptr, ret
    %gmstore(4)
    PUSH 2
    %mpt_schema_store
    PUSH lam_txn
    PUSH mpt_load_node
    JUMP
lam_txn:
    %gmstore(5)
    PUSH lam_rcpt
    PUSH mpt_load_node
    JUMP
lam_rcpt:
    %gmstore(6)
    JUMP

// (ret) -> (ptr): load one node (recursively) from the prover stream
GLOBAL mpt_load_node:
    PROVER_INPUT(mpt::load)
    // t, ret
    DUP1
    ISZERO
    PUSH mln_empty
    JUMPI
    DUP1
    PUSH 1
    EQ
    PUSH mln_hash
    JUMPI
    DUP1
    PUSH 2
    EQ
    PUSH mln_branch
    JUMPI
    DUP1
    PUSH 3
    EQ
    PUSH mln_ext
    JUMPI
    DUP1
    PUSH 4
    EQ
    PUSH mln_leaf
    JUMPI
    PANIC

mln_empty:
    %stack (t, ret) -> (ret, 0)
    JUMP

mln_hash:
    POP
    %stack () -> (2, mln_hash_p)
    PUSH mpt_alloc
    JUMP
mln_hash_p:
    // p, ret
    PUSH 1
    DUP2
    %tdstore
    // TD[p] = 1
    PROVER_INPUT(mpt::load)
    // h, p, ret
    %tdstore_at(1)
    %stack (p, ret) -> (ret, p)
    JUMP

mln_ext:
    POP
    %stack () -> (4, mln_ext_p)
    PUSH mpt_alloc
    JUMP
mln_ext_p:
    // p, ret
    PUSH 3
    DUP2
    %tdstore
    PROVER_INPUT(mpt::load)
    %tdstore_at(1)
    PROVER_INPUT(mpt::load)
    %tdstore_at(2)
    // p, ret
    PUSH mln_ext_c
    PUSH mpt_load_node
    JUMP
mln_ext_c:
    // c, p, ret
    %tdstore_at(3)
    %stack (p, ret) -> (ret, p)
    JUMP

mln_leaf:
    %stack (t) -> (4, mln_leaf_p)
    PUSH mpt_alloc
    JUMP
mln_leaf_p:
    // p, ret
    PUSH 4
    DUP2
    %tdstore
    PROVER_INPUT(mpt::load)
    %tdstore_at(1)
    PROVER_INPUT(mpt::load)
    %tdstore_at(2)
    PUSH mln_leaf_v
    PUSH mpt_load_value
    JUMP
mln_leaf_v:
    // v, p, ret
    %tdstore_at(3)
    %stack (p, ret) -> (ret, p)
    JUMP

mln_branch:
    POP
    %stack () -> (18, mln_br_p)
    PUSH mpt_alloc
    JUMP
mln_br_p:
    // p, ret
    PUSH 2
    DUP2
    %tdstore
    PROVER_INPUT(mpt::load)
    // flag, p, ret
    ISZERO
    PUSH mln_br_noval
    JUMPI
    PUSH mln_br_val
    PUSH mpt_load_value
    JUMP
mln_br_val:
    // v, p, ret
    %tdstore_at(17)
mln_br_noval:
    // p, ret — value slot stays 0 (fresh memory reads as zero)
    PUSH 0
    // i = 0, p, ret
mln_br_loop:
    DUP1
    PUSH 16
    EQ
    PUSH mln_br_done
    JUMPI
    PUSH mln_br_child
    PUSH mpt_load_node
    JUMP
mln_br_child:
    // c, i, p, ret
    %stack (c, i, p) -> (p, 1, i, c, i, p)
    ADD
    ADD
    // p + 1 + i, c, i, p, ret
    %tdstore
    // i, p, ret
    %add_const(1)
    PUSH mln_br_loop
    JUMP
mln_br_done:
    %stack (i, p, ret) -> (ret, p)
    JUMP

// (ret) -> (vptr): load one VALUE per the active schema
GLOBAL mpt_load_value:
    %mpt_schema_load
    DUP1
    ISZERO
    PUSH mlv_state
    JUMPI
    PUSH 1
    EQ
    PUSH mlv_storage
    JUMPI
    // schema 2: bytes — stream is [len, byte x len]
    PROVER_INPUT(mpt::load)
    // len, ret
    DUP1
    %add_const(1)
    %stack (n) -> (n, mlv_bytes_p)
    PUSH mpt_alloc
    JUMP
mlv_bytes_p:
    // v, len, ret
    DUP2
    DUP2
    %tdstore
    // TD[v] = len; v, len, ret
    PUSH 0
    // i, v, len, ret
mlv_b_loop:
    DUP3
    DUP2
    EQ
    PUSH mlv_b_done
    JUMPI
    PROVER_INPUT(mpt::load)
    // b, i, v, len, ret
    %stack (b, i, v) -> (v, 1, i, b, i, v)
    ADD
    ADD
    // v + 1 + i, b, i, v, len, ret
    %tdstore
    %add_const(1)
    PUSH mlv_b_loop
    JUMP
mlv_b_done:
    %stack (i, v, len, ret) -> (ret, v)
    JUMP

mlv_storage:
    // scalar value [x]
    %stack () -> (1, mlv_st_p)
    PUSH mpt_alloc
    JUMP
mlv_st_p:
    // v, ret
    PROVER_INPUT(mpt::load)
    // x, v, ret
    DUP2
    %tdstore
    %stack (v, ret) -> (ret, v)
    JUMP

mlv_state:
    // account: stream is nonce, balance, <storage subtrie>, code_hash
    POP
    %stack () -> (4, mlv_acct_p)
    PUSH mpt_alloc
    JUMP
mlv_acct_p:
    // v, ret
    PROVER_INPUT(mpt::load)
    // nonce, v, ret
    DUP2
    %tdstore
    PROVER_INPUT(mpt::load)
    %tdstore_at(1)
    // descend into the storage subtrie with schema 1
    PUSH 1
    %mpt_schema_store
    PUSH mlv_acct_s
    PUSH mpt_load_node
    JUMP
mlv_acct_s:
    // sptr, v, ret
    PUSH 0
    %mpt_schema_store
    %tdstore_at(2)
    PROVER_INPUT(mpt::load)
    %tdstore_at(3)
    %stack (v, ret) -> (ret, v)
    JUMP

// ---------------------------------------------------------------------------
// mpt_read (reference mpt/read.asm, spec tests/mpt/read.rs)
// ---------------------------------------------------------------------------

// (ptr, cnt, key, ret) -> (value_ptr or 0)
GLOBAL mpt_read:
    DUP1
    %tdload
    // t, ptr, cnt, key, ret
    DUP1
    ISZERO
    PUSH mr_absent_t
    JUMPI
    DUP1
    PUSH 1
    EQ
    PUSH mr_absent_t
    JUMPI
    DUP1
    PUSH 2
    EQ
    PUSH mr_branch
    JUMPI
    DUP1
    PUSH 3
    EQ
    PUSH mr_ext
    JUMPI
    PUSH 4
    EQ
    PUSH mr_leaf
    JUMPI
    PANIC

mr_absent_t:
    POP
mr_absent:
    %stack (ptr, cnt, key, ret) -> (ret, 0)
    JUMP

mr_leaf:
    // match iff count == cnt and packed == key
    DUP1
    %add_const(1)
    %tdload
    DUP3
    EQ
    ISZERO
    PUSH mr_absent
    JUMPI
    DUP1
    %add_const(2)
    %tdload
    DUP4
    EQ
    ISZERO
    PUSH mr_absent
    JUMPI
    %add_const(3)
    %tdload
    %stack (v, cnt, key, ret) -> (ret, v)
    JUMP

mr_branch:
    POP
    DUP2
    ISZERO
    PUSH mr_br_val
    JUMPI
    %stack (ptr, cnt, key) -> (cnt, key, mr_br_split, ptr, cnt)
    PUSH nib_split
    JUMP
mr_br_split:
    // nib, rem, ptr, cnt, ret
    %stack (nib, rem, ptr, cnt) -> (ptr, 1, nib, cnt, 1, rem)
    ADD
    ADD
    %tdload
    // child = TD[ptr+1+nib], cnt, 1, rem, ret
    %stack (child, cnt, one, rem) -> (cnt, one, child, rem)
    SUB
    // cnt-1, child, rem, ret
    %stack (cnt1, child, rem) -> (child, cnt1, rem)
    PUSH mpt_read
    JUMP
mr_br_val:
    %stack (ptr, cnt, key) -> (ptr, 17)
    ADD
    %tdload
    %stack (v, ret) -> (ret, v)
    JUMP

mr_ext:
    POP
    // pcnt = TD[ptr+1]
    DUP1
    %add_const(1)
    %tdload
    // pcnt, ptr, cnt, key, ret
    %stack (pcnt, ptr, cnt, key) -> (cnt, pcnt, mr_ext_pw, pcnt, ptr, cnt, key)
    SUB
    // cnt - pcnt, mr_ext_pw, pcnt, ptr, cnt, key, ret
    PUSH pow16
    JUMP
mr_ext_pw:
    // pw, pcnt, ptr, cnt, key, ret
    %stack (pw, pcnt, ptr, cnt, key) -> (key, pw, pw, pcnt, ptr, cnt, key)
    DIV
    // keytop = key / pw, pw, pcnt, ptr, cnt, key, ret
    DUP4
    %add_const(2)
    %tdload
    EQ
    ISZERO
    PUSH mr_ext_absent
    JUMPI
    // rem = key % pw; recurse (child, cnt - pcnt, rem)
    %stack (pw, pcnt, ptr, cnt, key) -> (key, pw, cnt, pcnt, ptr)
    MOD
    // rem, cnt, pcnt, ptr, ret
    %stack (rem, cnt, pcnt, ptr) -> (cnt, pcnt, ptr, rem)
    SUB
    // cnt', ptr, rem, ret
    SWAP1
    %add_const(3)
    %tdload
    // child, cnt', rem, ret
    PUSH mpt_read
    JUMP
mr_ext_absent:
    %stack (pw, pcnt, ptr, cnt, key, ret) -> (ret, 0)
    JUMP

// ---------------------------------------------------------------------------
// mpt_insert (reference mpt/insert.asm, spec tests/mpt/insert.rs;
// semantics == evm/mpt.py trie_insert / eth_trie_utils)
// ---------------------------------------------------------------------------

// (cnt, key, vptr, ret) -> (leaf_ptr): allocate LEAF[cnt, key, vptr]
GLOBAL mpt_new_leaf:
    %stack () -> (4, mnl_p)
    PUSH mpt_alloc
    JUMP
mnl_p:
    // p, cnt, key, vptr, ret
    PUSH 4
    DUP2
    %tdstore
    DUP2
    %tdstore_at(1)
    DUP3
    %tdstore_at(2)
    DUP4
    %tdstore_at(3)
    %stack (p, cnt, key, vptr, ret) -> (ret, p)
    JUMP

// (ptr, cnt, key, vptr, ret) -> (new_root_ptr)
GLOBAL mpt_insert:
    DUP1
    %tdload
    // t, ptr, cnt, key, vptr, ret
    DUP1
    ISZERO
    PUSH mi_empty
    JUMPI
    DUP1
    PUSH 2
    EQ
    PUSH mi_branch
    JUMPI
    DUP1
    PUSH 3
    EQ
    PUSH mi_split
    JUMPI
    DUP1
    PUSH 4
    EQ
    PUSH mi_split
    JUMPI
    // HASH (or garbage): cannot insert below a hashed-out subtree
    PANIC

mi_empty:
    %stack (t, ptr, cnt, key, vptr) -> (cnt, key, vptr)
    PUSH mpt_new_leaf
    JUMP

mi_branch:
    POP
    // cnt == 0 -> set the branch value in place
    DUP2
    ISZERO
    PUSH mi_br_val
    JUMPI
    %stack (ptr, cnt, key, vptr) -> (cnt, key, mi_br_split, ptr, cnt, vptr)
    PUSH nib_split
    JUMP
mi_br_split:
    // nib, rem, ptr, cnt, vptr, ret
    %stack (nib, rem, ptr, cnt, vptr) ->
        (ptr, 1, nib, cnt, 1, rem, vptr, nib, ptr)
    ADD
    ADD
    %tdload
    // child = TD[ptr+1+nib], cnt, 1, rem, vptr, nib, ptr, ret
    %stack (child, cnt, one, rem, vptr) ->
        (cnt, one, child, rem, vptr, mi_br_back)
    SUB
    %stack (cnt1, child, rem, vptr, back) -> (child, cnt1, rem, vptr, back)
    PUSH mpt_insert
    JUMP
mi_br_back:
    // newchild, nib, ptr, ret
    %stack (newchild, nib, ptr) -> (ptr, 1, nib, newchild, ptr)
    ADD
    ADD
    // ptr+1+nib, newchild, ptr, ret
    %tdstore
    %stack (ptr, ret) -> (ret, ptr)
    JUMP
mi_br_val:
    // ptr, cnt, key, vptr, ret
    DUP4
    DUP2
    %add_const(17)
    %tdstore
    %stack (ptr, cnt, key, vptr, ret) -> (ret, ptr)
    JUMP

// leaf / extension: split on the common nibble prefix.  Locals go to the
// fixed milocal slots (1=t, 2=ptr, 3=cp, 4=ncnt, 5=npk, 6=cnt, 7=key,
// 8=vptr, 9=branch_ptr) — the divergence path never re-enters mpt_insert.
mi_split:
    // t, ptr, cnt, key, vptr, ret
    %milocal_store(1)
    DUP1
    %milocal_store(2)
    // ptr, cnt, key, vptr, ret
    DUP1
    %add_const(1)
    %tdload
    %milocal_store(4)
    DUP1
    %add_const(2)
    %tdload
    %milocal_store(5)
    DUP2
    %milocal_store(6)
    DUP3
    %milocal_store(7)
    DUP4
    %milocal_store(8)
    // cp = common_prefix(ncnt, npk, cnt, key)
    %milocal_load(7)
    %milocal_load(6)
    %milocal_load(5)
    %milocal_load(4)
    // ncnt, npk, cnt, key, (ptr, cnt, key, vptr, ret)
    %stack (ncnt, npk, cnt, key) -> (ncnt, npk, cnt, key, mi_cp)
    PUSH mpt_common_prefix
    JUMP
mi_cp:
    // cp, ptr, cnt, key, vptr, ret
    %milocal_store(3)
    // overwrite case: t == LEAF and cp == ncnt and cp == cnt
    %milocal_load(1)
    PUSH 4
    EQ
    ISZERO
    PUSH mi_not_overwrite
    JUMPI
    %milocal_load(4)
    %milocal_load(3)
    EQ
    ISZERO
    PUSH mi_not_overwrite
    JUMPI
    %milocal_load(6)
    %milocal_load(3)
    EQ
    ISZERO
    PUSH mi_not_overwrite
    JUMPI
    // LEAF with identical key: replace the value in place
    DUP4
    DUP2
    %add_const(3)
    %tdstore
    %stack (ptr, cnt, key, vptr, ret) -> (ret, ptr)
    JUMP
mi_not_overwrite:
    // extension descend: t == EXT and cp == ncnt
    %milocal_load(1)
    PUSH 3
    EQ
    ISZERO
    PUSH mi_diverge
    JUMPI
    %milocal_load(4)
    %milocal_load(3)
    EQ
    ISZERO
    PUSH mi_diverge
    JUMPI
    // rem_cnt = cnt - ncnt (== cnt - cp); rem = key % 16^rem_cnt
    %milocal_load(4)
    %milocal_load(6)
    SUB
    // rem_cnt, ptr, cnt, key, vptr, ret
    %stack (rc) -> (rc, mi_ext_pw2)
    PUSH pow16
    JUMP
mi_ext_pw2:
    // pw, ptr, cnt, key, vptr, ret
    %milocal_load(7)
    // key, pw, ptr, cnt, key, vptr, ret
    MOD
    // rem = key % pw, ptr, cnt, key, vptr, ret
    %milocal_load(4)
    %milocal_load(6)
    SUB
    // rem_cnt, rem, ptr, cnt, key, vptr, ret
    %milocal_load(2)
    %add_const(3)
    %tdload
    // child, rem_cnt, rem, ptr, cnt, key, vptr, ret
    %stack (child, rc, rem, ptr, cnt, key, vptr) ->
        (child, rc, rem, vptr, mi_ext_back, ptr)
    PUSH mpt_insert
    JUMP
mi_ext_back:
    // newchild, ptr, ret
    DUP2
    %add_const(3)
    %tdstore
    %stack (ptr, ret) -> (ret, ptr)
    JUMP

mi_diverge:
    // (ptr, cnt, key, vptr, ret) on stack; locals 1..8 hold the frame.
    %stack (ptr, cnt, key, vptr) -> (18, mi_dv_b)
    PUSH mpt_alloc
    JUMP
mi_dv_b:
    // b, ret
    DUP1
    %milocal_store(9)
    PUSH 2
    DUP2
    %tdstore
    POP
    // ret
    // --- old-node remainder: o_cnt = ncnt - cp; o_pk = npk % 16^o_cnt ---
    %milocal_load(3)
    %milocal_load(4)
    SUB
    // o_cnt, ret
    DUP1
    ISZERO
    PUSH mi_dv_oldval
    JUMPI
    // cp == 0 (o_cnt == ncnt): o_pk = npk verbatim — 16^64 would wrap to
    // zero in U256 and poison the MOD
    %milocal_load(4)
    DUP2
    EQ
    PUSH mi_dv_o_full
    JUMPI
    %stack (oc) -> (oc, mi_dv_opw, oc)
    PUSH pow16
    JUMP
mi_dv_opw:
    // pw, o_cnt, ret
    %milocal_load(5)
    MOD
    // o_pk = npk % pw, o_cnt, ret
    SWAP1
    // o_cnt, o_pk, ret
    PUSH mi_dv_osp
    JUMP
mi_dv_o_full:
    // o_cnt, ret
    %milocal_load(5)
    SWAP1
    // o_cnt, o_pk(=npk), ret
mi_dv_osp:
    %stack (oc, opk) -> (oc, opk, mi_dv_osplit)
    PUSH nib_split
    JUMP
mi_dv_osplit:
    // onib, orem, ret
    // old node's child/value pointer:
    %milocal_load(2)
    %add_const(3)
    %tdload
    // oldp = TD[ptr+3], onib, orem, ret
    %milocal_load(1)
    PUSH 4
    EQ
    PUSH mi_dv_oldleaf
    JUMPI
    // === old node is an EXTENSION ===
    // rest_cnt = o_cnt - 1 = ncnt - cp - 1
    %milocal_load(3)
    %milocal_load(4)
    SUB
    %sub_const(1)
    // rest_cnt, oldp, onib, orem, ret
    DUP1
    ISZERO
    PUSH mi_dv_edirect
    JUMPI
    // inner = new EXT[rest_cnt, orem, oldp]
    %stack (rc, oldp, onib, orem) -> (4, mi_dv_ealloc, rc, oldp, onib, orem)
    PUSH mpt_alloc
    JUMP
mi_dv_ealloc:
    // e, rest_cnt, oldp, onib, orem, ret
    PUSH 3
    DUP2
    %tdstore
    DUP2
    %tdstore_at(1)
    DUP5
    %tdstore_at(2)
    DUP3
    %tdstore_at(3)
    // e, rest_cnt, oldp, onib, orem, ret
    %stack (e, rc, oldp, onib, orem) -> (e, onib)
    PUSH mi_dv_oldstore
    JUMP
mi_dv_edirect:
    // rest_cnt(=0), oldp, onib, orem, ret -> inner = oldp
    %stack (rc, oldp, onib, orem) -> (oldp, onib)
    PUSH mi_dv_oldstore
    JUMP
mi_dv_oldleaf:
    // oldp, onib, orem, ret — old-leaf remainder becomes
    // LEAF[o_cnt - 1, orem, oldp]
    %milocal_load(3)
    %milocal_load(4)
    SUB
    %sub_const(1)
    // lcnt, oldp, onib, orem, ret
    %stack (lcnt, oldp, onib, orem) ->
        (lcnt, orem, oldp, mi_dv_lleaf, onib)
    PUSH mpt_new_leaf
    JUMP
mi_dv_lleaf:
    // ol, onib, ret
    PUSH mi_dv_oldstore
    JUMP
mi_dv_oldval:
    // o_cnt(=0), ret : the old LEAF's value -> branch value slot
    // (an extension with o_cnt == 0 would have descended; only leaves
    // reach here)
    POP
    %milocal_load(1)
    PUSH 4
    EQ
    ISZERO
    PUSH mi_dv_panic
    JUMPI
    %milocal_load(2)
    %add_const(3)
    %tdload
    // oldv, ret
    %milocal_load(9)
    %add_const(17)
    %tdstore
    PUSH mi_dv_new
    JUMP

mi_dv_oldstore:
    // (node, onib, ret): TD[b + 1 + onib] = node
    %milocal_load(9)
    %stack (b, node, onib) -> (b, 1, onib, node)
    ADD
    ADD
    %tdstore
    // ret

mi_dv_new:
    // --- new-key remainder: n_cnt = cnt - cp; n_pk = key % 16^n_cnt ---
    %milocal_load(3)
    %milocal_load(6)
    SUB
    // n_cnt, ret
    DUP1
    ISZERO
    PUSH mi_dv_newval
    JUMPI
    // cp == 0 (n_cnt == cnt): n_pk = key verbatim (16^64 wraps to zero)
    %milocal_load(6)
    DUP2
    EQ
    PUSH mi_dv_n_full
    JUMPI
    %stack (nc) -> (nc, mi_dv_npw, nc)
    PUSH pow16
    JUMP
mi_dv_npw:
    // pw, n_cnt, ret
    %milocal_load(7)
    MOD
    // n_pk = key % pw, n_cnt, ret
    SWAP1
    PUSH mi_dv_nsp
    JUMP
mi_dv_n_full:
    // n_cnt, ret
    %milocal_load(7)
    SWAP1
    // n_cnt, n_pk(=key), ret
mi_dv_nsp:
    %stack (nc, npack) -> (nc, npack, mi_dv_nsplit)
    PUSH nib_split
    JUMP
mi_dv_nsplit:
    // nnib, nrem, ret — new leaf LEAF[n_cnt - 1, nrem, vptr]
    %milocal_load(8)
    // vptr, nnib, nrem, ret
    %milocal_load(3)
    %milocal_load(6)
    SUB
    %sub_const(1)
    // lcnt, vptr, nnib, nrem, ret
    %stack (lcnt, vptr, nnib, nrem) ->
        (lcnt, nrem, vptr, mi_dv_nleaf, nnib)
    PUSH mpt_new_leaf
    JUMP
mi_dv_nleaf:
    // nl, nnib, ret
    %milocal_load(9)
    %stack (b, nl, nnib) -> (b, 1, nnib, nl)
    ADD
    ADD
    %tdstore
    PUSH mi_dv_fin
    JUMP
mi_dv_newval:
    // n_cnt(=0), ret : new value -> branch value slot
    POP
    %milocal_load(8)
    %milocal_load(9)
    %add_const(17)
    %tdstore

mi_dv_fin:
    // if cp == 0: return b; else wrap in EXT[cp, key / 16^(cnt-cp), b]
    %milocal_load(3)
    ISZERO
    PUSH mi_dv_nopre
    JUMPI
    %milocal_load(3)
    %milocal_load(6)
    SUB
    // cnt - cp, ret
    %stack (d) -> (d, mi_dv_ppw)
    PUSH pow16
    JUMP
mi_dv_ppw:
    // pw, ret
    %milocal_load(7)
    // key, pw, ret
    DIV
    // prefix = key / pw, ret
    %stack (prefix) -> (4, mi_dv_palloc, prefix)
    PUSH mpt_alloc
    JUMP
mi_dv_palloc:
    // e, prefix, ret
    PUSH 3
    DUP2
    %tdstore
    %milocal_load(3)
    %tdstore_at(1)
    DUP2
    %tdstore_at(2)
    %milocal_load(9)
    %tdstore_at(3)
    %stack (e, prefix, ret) -> (ret, e)
    JUMP
mi_dv_nopre:
    %milocal_load(9)
    %stack (b, ret) -> (ret, b)
    JUMP
mi_dv_panic:
    PANIC

// ---------------------------------------------------------------------------
// hashing (reference mpt/hash.asm, spec tests/mpt/hash.rs): yellow-paper
// appendix-D node encoding, keccak'd through KECCAK_GENERAL
// ---------------------------------------------------------------------------

// (pos, count, packed, is_leaf, ret) -> (pos'): hex-prefix encoding of a
// nibble string (yellow paper appendix C) written as a complete RLP
// STRING item into TrieEncodedChild at pos — the 1 + count/2 hp bytes get
// an 0x80+len header unless they are a single byte (< 0x80 always: the
// flag nibble is at most 3)
GLOBAL hp_write:
    DUP2
    PUSH 2
    GT
    PUSH hp_nohdr
    JUMPI
    DUP2
    %stack (c) -> (c, 2)
    DIV
    %add_const(0x81)
    // hdr = 0x80 + 1 + count/2, pos, count, packed, is_leaf, ret
    DUP2
    %stack (pos, hdr) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, pos, hdr)
    MSTORE_GENERAL
    %add_const(1)
hp_nohdr:
    DUP2
    PUSH 1
    AND
    PUSH hp_odd
    JUMPI
    // even count: first byte = (2*is_leaf) << 4
    DUP4
    %stack (l) -> (l, 32)
    MUL
    // fb, pos, count, packed, is_leaf, ret
    DUP2
    %stack (pos, fb) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, pos, fb)
    MSTORE_GENERAL
    // pos, count, packed, is_leaf, ret
    %stack (pos, count, packed, is_leaf) -> (count, 2, pos, packed)
    DIV
    // nb = count/2, pos, packed, ret
    %stack (nb, pos, packed) -> (pos, 1, nb, packed, nb, pos)
    ADD
    // pos+1, nb, packed, nb, pos, ret
    %stack (pos1, nb, packed) -> (@SEGMENT_TRIE_ENCODED_CHILD, packed, pos1, nb, hpw_done)
    PUSH store_be
    JUMP
hp_odd:
    // pos, count, packed, is_leaf, ret
    // pw = 16^(count-1)
    DUP2
    %sub_const(1)
    %stack (k) -> (k, hpo_pw)
    PUSH pow16
    JUMP
hpo_pw:
    // pw, pos, count, packed, is_leaf, ret
    // nib0 = packed / pw
    DUP4
    DUP2
    SWAP1
    // packed, pw, pw, pos, count, packed, is_leaf, ret
    DIV
    // nib0, pw, pos, count, packed, is_leaf, ret
    // fb = (1 + 2*is_leaf) << 4 | nib0  =  16 + 32*is_leaf + nib0
    DUP6
    %stack (l) -> (l, 32)
    MUL
    ADD
    %add_const(16)
    // fb, pw, pos, count, packed, is_leaf, ret
    DUP3
    %stack (pos, fb) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, pos, fb)
    MSTORE_GENERAL
    // pw, pos, count, packed, is_leaf, ret
    // rest = packed mod pw
    DUP4
    SWAP1
    // pw, packed ... -> packed % pw
    SWAP1
    MOD
    // rest, pos, count, packed, is_leaf, ret
    // nb = (count-1)/2
    DUP3
    %sub_const(1)
    %stack (c1) -> (c1, 2)
    DIV
    // nb, rest, pos, count, packed, is_leaf, ret
    %stack (nb, rest, pos, count, packed, is_leaf) -> (pos, 1, nb, rest, nb, pos)
    ADD
    %stack (pos1, nb, rest) -> (@SEGMENT_TRIE_ENCODED_CHILD, rest, pos1, nb, hpw_done)
    PUSH store_be
    JUMP
hpw_done:
    // nb, pos, ret
    ADD
    %add_const(1)
    %stack (p, ret) -> (ret, p)
    JUMP

// (q, cpay, cblen, ret) -> (q'): append a child reference c(J) at q —
// 0xa0 + 32 digest bytes when cblen == 32, the raw RLP bytes verbatim
// otherwise
GLOBAL append_child_ref:
    DUP3
    PUSH 32
    EQ
    PUSH acr_hash
    JUMPI
    %stack (q, cpay, cblen) -> (@SEGMENT_TRIE_ENCODED_CHILD, cpay, q, cblen, acr_done, q, cblen)
    PUSH store_be
    JUMP
acr_done:
    // q, cblen, ret
    ADD
    %stack (qn, ret) -> (ret, qn)
    JUMP
acr_hash:
    DUP1
    %stack (q) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, q, 0xa0)
    MSTORE_GENERAL
    // q, cpay, cblen(=32), ret
    %stack (q, cpay, cblen) -> (q, 1, cpay, q, cblen)
    ADD
    // q+1, cpay, q, cblen, ret
    %stack (q1, cpay, q, cblen) -> (@SEGMENT_TRIE_ENCODED_CHILD, cpay, q1, 32, acr_hdone, q, cblen)
    PUSH store_be
    JUMP
acr_hdone:
    // q, 32, ret
    ADD
    %add_const(1)
    %stack (qn, ret) -> (ret, qn)
    JUMP

// (rlp_pos, q, ret) -> (payload, blen): shared node tail — list-prefix
// the payload at [rlp_pos+9, q), then inline (<32 bytes) or keccak
GLOBAL mpt_finish_node:
    %stack (rlp_pos, q) -> (rlp_pos, 9, q)
    ADD
    // ps, q, ret
    DUP1
    DUP3
    SUB
    // L = q - ps, ps, q, ret
    %stack (l, ps) -> (@SEGMENT_TRIE_ENCODED_CHILD, ps, l, mfn_prefix)
    PUSH rlp_write_list_prefix
    JUMP
mfn_prefix:
    // hstart, q, ret
    DUP2
    DUP2
    SWAP1
    SUB
    // total = q - hstart, hstart, q, ret
    DUP1
    PUSH 32
    GT
    PUSH mfn_inline
    JUMPI
    %stack (total, hstart, q) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, hstart, total)
    KECCAK_GENERAL
    // digest (LE-packed), ret
    %stack (d) -> (d, mfn_swapped)
    PUSH u256_byteswap
    JUMP
mfn_swapped:
    %stack (d, ret) -> (ret, d, 32)
    JUMP
mfn_inline:
    %stack (total, hstart, q) -> (@SEGMENT_TRIE_ENCODED_CHILD, hstart, total, mfn_loaded, total)
    PUSH load_be
    JUMP
mfn_loaded:
    // payload, total, ret
    %stack (payload, total, ret) -> (ret, payload, total)
    JUMP

// (rlp_pos, a0, vptr, ret) -> (astart, aend): write the value's RLP
// string payload (account list / rlp(scalar) / raw bytes) into
// TrieEncodedChild; state accounts first hash their storage subtree
// (schema flips to 1 for the descent)
GLOBAL mpt_encode_value:
    %mpt_schema_load
    DUP1
    ISZERO
    PUSH mev_state
    JUMPI
    PUSH 1
    EQ
    PUSH mev_storage
    JUMPI
    // bytes: n = TD[vptr]; copy TD[vptr+1 ..] -> ENC[a0 ..]
    DUP3
    %tdload
    // n, rlp_pos, a0, vptr, ret
    DUP4
    %add_const(1)
    // src = vptr+1, n, rlp_pos, a0, vptr, ret
    DUP4
    // a0, src, n, rlp_pos, a0, vptr, ret
    %stack (a0, src, n) -> (@SEGMENT_TRIE_ENCODED_CHILD, a0, @SEGMENT_TRIE_DATA, src, n, mev_b_cp, n)
    PUSH mem_copy
    JUMP
mev_b_cp:
    // n, rlp_pos, a0, vptr, ret
    DUP3
    ADD
    // aend = a0 + n, rlp_pos, a0, vptr, ret
    %stack (aend, rlp_pos, a0, vptr, ret) -> (ret, a0, aend)
    JUMP
mev_storage:
    // scalar x = TD[vptr]
    DUP3
    %tdload
    // x, rlp_pos, a0, vptr, ret
    DUP3
    // a0, x, rlp_pos, a0, vptr, ret
    %stack (a0, x) -> (@SEGMENT_TRIE_ENCODED_CHILD, a0, x, mev_s_done)
    PUSH rlp_write_scalar
    JUMP
mev_s_done:
    // a1, rlp_pos, a0, vptr, ret
    %stack (a1, rlp_pos, a0, vptr, ret) -> (ret, a0, a1)
    JUMP
mev_state:
    POP
    // rlp_pos, a0, vptr, ret
    // 1) storage subtree root (schema 1, scratch = rlp_pos)
    PUSH 1
    %mpt_schema_store
    DUP3
    %add_const(2)
    %tdload
    // sptr, rlp_pos, a0, vptr, ret
    DUP2
    // rlp_pos, sptr, rlp_pos, a0, vptr, ret
    %stack (rp, sptr) -> (rp, sptr, mev_a_sroot)
    PUSH mpt_hash_root
    JUMP
mev_a_sroot:
    // sroot, rlp_pos, a0, vptr, ret
    PUSH 0
    %mpt_schema_store
    // 2) account items at a0: rlp(nonce), rlp(balance), 0xa0+sroot,
    //    0xa0+code_hash
    DUP4
    %tdload
    // nonce, sroot, rlp_pos, a0, vptr, ret
    DUP4
    // a0, nonce, sroot, rlp_pos, a0, vptr, ret
    %stack (a0, nonce) -> (@SEGMENT_TRIE_ENCODED_CHILD, a0, nonce, mev_a_n)
    PUSH rlp_write_scalar
    JUMP
mev_a_n:
    // a1, sroot, rlp_pos, a0, vptr, ret
    DUP5
    %add_const(1)
    %tdload
    // balance, a1, sroot, rlp_pos, a0, vptr, ret
    SWAP1
    %stack (a1, balance) -> (@SEGMENT_TRIE_ENCODED_CHILD, a1, balance, mev_a_b)
    PUSH rlp_write_scalar
    JUMP
mev_a_b:
    // a2, sroot, rlp_pos, a0, vptr, ret
    %stack (a2, sroot) -> (a2, sroot, 32, mev_a_sr)
    PUSH append_child_ref
    JUMP
mev_a_sr:
    // a3, rlp_pos, a0, vptr, ret
    DUP4
    %add_const(3)
    %tdload
    // ch, a3, rlp_pos, a0, vptr, ret
    SWAP1
    %stack (a3, ch) -> (a3, ch, 32, mev_a_ch)
    PUSH append_child_ref
    JUMP
mev_a_ch:
    // a4, rlp_pos, a0, vptr, ret
    %stack (a4, rlp_pos, a0) -> (a4, a0, a0, rlp_pos, a4)
    SUB
    // apl = a4 - a0, a0, rlp_pos, a4, vptr, ret
    SWAP1
    %stack (a0, apl) -> (@SEGMENT_TRIE_ENCODED_CHILD, a0, apl, mev_a_lp)
    PUSH rlp_write_list_prefix
    JUMP
mev_a_lp:
    // ahstart, rlp_pos, a4, vptr, ret
    %stack (ahstart, rlp_pos, a4, vptr, ret) -> (ret, ahstart, a4)
    JUMP

// (rlp_pos, ptr, ret) -> (payload, blen): c(J) of the node at ptr —
// blen == 32 means payload is the keccak digest (big-endian int),
// blen < 32 means payload is the raw RLP packed big-endian
GLOBAL mpt_hash_node:
    DUP2
    %tdload
    // t, rlp_pos, ptr, ret
    DUP1
    ISZERO
    PUSH mhn_empty
    JUMPI
    DUP1
    PUSH 1
    EQ
    PUSH mhn_hash
    JUMPI
    DUP1
    PUSH 2
    EQ
    PUSH mhn_branch
    JUMPI
    DUP1
    PUSH 3
    EQ
    PUSH mhn_ext
    JUMPI
    DUP1
    PUSH 4
    EQ
    PUSH mhn_leaf
    JUMPI
    PANIC

mhn_empty:
    // c(empty) = 0x80 (the RLP of the empty string)
    %stack (t, rlp_pos, ptr, ret) -> (ret, 0x80, 1)
    JUMP

mhn_hash:
    POP
    // rlp_pos, ptr, ret
    SWAP1
    %add_const(1)
    %tdload
    // h, rlp_pos, ret
    %stack (h, rlp_pos, ret) -> (ret, h, 32)
    JUMP

mhn_ext:
    POP
    // rlp_pos, ptr, ret
    DUP2
    %add_const(3)
    %tdload
    // child, rlp_pos, ptr, ret
    DUP2
    // rlp_pos, child, rlp_pos, ptr, ret
    %stack (rp, child) -> (rp, child, mhe_child)
    PUSH mpt_hash_node
    JUMP
mhe_child:
    // cpay, cblen, rlp_pos, ptr, ret
    DUP4
    %add_const(1)
    %tdload
    // count, cpay, cblen, rlp_pos, ptr, ret
    DUP5
    %add_const(2)
    %tdload
    // packed, count, cpay, cblen, rlp_pos, ptr, ret
    DUP5
    %add_const(9)
    // ps, packed, count, cpay, cblen, rlp_pos, ptr, ret
    %stack (ps, packed, count) -> (ps, count, packed, 0, mhe_hp)
    PUSH hp_write
    JUMP
mhe_hp:
    // p1, cpay, cblen, rlp_pos, ptr, ret
    %stack (p1, cpay, cblen) -> (p1, cpay, cblen, mhe_ref)
    PUSH append_child_ref
    JUMP
mhe_ref:
    // q, rlp_pos, ptr, ret
    %stack (q, rlp_pos, ptr) -> (rlp_pos, q)
    PUSH mpt_finish_node
    JUMP

mhn_branch:
    POP
    // rlp_pos, ptr, ret
    DUP1
    %add_const(9)
    // q = rlp_pos + 9, rlp_pos, ptr, ret
    PUSH 0
    // i, q, rlp_pos, ptr, ret
mhb_loop:
    DUP1
    PUSH 16
    EQ
    PUSH mhb_valtail
    JUMPI
    DUP4
    DUP2
    ADD
    %add_const(1)
    %tdload
    // child = TD[ptr+1+i], i, q, rlp_pos, ptr, ret
    DUP3
    // q, child, i, q, rlp_pos, ptr, ret   (child scratch = current q)
    %stack (q, child) -> (q, child, mhb_child)
    PUSH mpt_hash_node
    JUMP
mhb_child:
    // cpay, cblen, i, q, rlp_pos, ptr, ret
    %stack (cpay, cblen, i, q) -> (q, cpay, cblen, mhb_ref, i)
    PUSH append_child_ref
    JUMP
mhb_ref:
    // q2, i, rlp_pos, ptr, ret
    SWAP1
    %add_const(1)
    // i+1, q2, rlp_pos, ptr, ret
    PUSH mhb_loop
    JUMP
mhb_valtail:
    // i(=16), q, rlp_pos, ptr, ret
    POP
    DUP3
    %add_const(17)
    %tdload
    // vptr, q, rlp_pos, ptr, ret
    DUP1
    ISZERO
    PUSH mhb_noval
    JUMPI
    // 17th item: value string
    DUP3
    %add_const(600)
    // a0, vptr, q, rlp_pos, ptr, ret
    DUP4
    // rlp_pos, a0, vptr, q, rlp_pos, ptr, ret
    %stack (rp, a0, vptr) -> (rp, a0, vptr, mhb_venc)
    PUSH mpt_encode_value
    JUMP
mhb_venc:
    // astart, aend, q, rlp_pos, ptr, ret
    %stack (astart, aend) -> (aend, astart, astart)
    SUB
    // vlen, astart, q, rlp_pos, ptr, ret
    %stack (vlen, astart, q) -> (@SEGMENT_TRIE_ENCODED_CHILD, q, vlen, mhb_vs, vlen, astart)
    PUSH rlp_write_str_prefix_fwd
    JUMP
mhb_vs:
    // q2, vlen, astart, rlp_pos, ptr, ret
    %stack (q2, vlen, astart) -> (@SEGMENT_TRIE_ENCODED_CHILD, q2, @SEGMENT_TRIE_ENCODED_CHILD, astart, vlen, mhb_cp, q2, vlen)
    PUSH mem_copy
    JUMP
mhb_cp:
    // q2, vlen, rlp_pos, ptr, ret
    ADD
    // q3, rlp_pos, ptr, ret
    %stack (q3, rlp_pos, ptr) -> (rlp_pos, q3)
    PUSH mpt_finish_node
    JUMP
mhb_noval:
    // vptr(=0), q, rlp_pos, ptr, ret
    POP
    DUP1
    %stack (q) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, q, 0x80)
    MSTORE_GENERAL
    %add_const(1)
    %stack (q1, rlp_pos, ptr) -> (rlp_pos, q1)
    PUSH mpt_finish_node
    JUMP

mhn_leaf:
    POP
    // rlp_pos, ptr, ret
    DUP2
    %add_const(3)
    %tdload
    // vptr, rlp_pos, ptr, ret
    DUP2
    %add_const(600)
    // a0, vptr, rlp_pos, ptr, ret
    DUP3
    // rlp_pos, a0, vptr, rlp_pos, ptr, ret
    %stack (rp, a0, vptr) -> (rp, a0, vptr, mhl_venc)
    PUSH mpt_encode_value
    JUMP
mhl_venc:
    // astart, aend, rlp_pos, ptr, ret
    %stack (astart, aend) -> (aend, astart, astart)
    SUB
    // vlen, astart, rlp_pos, ptr, ret
    DUP4
    %add_const(1)
    %tdload
    // count, vlen, astart, rlp_pos, ptr, ret
    DUP5
    %add_const(2)
    %tdload
    // packed, count, vlen, astart, rlp_pos, ptr, ret
    DUP5
    %add_const(9)
    // ps, packed, count, vlen, astart, rlp_pos, ptr, ret
    %stack (ps, packed, count) -> (ps, count, packed, 1, mhl_hp)
    PUSH hp_write
    JUMP
mhl_hp:
    // p1, vlen, astart, rlp_pos, ptr, ret
    DUP2
    %stack (vlen, p1) -> (@SEGMENT_TRIE_ENCODED_CHILD, p1, vlen, mhl_vs)
    PUSH rlp_write_str_prefix_fwd
    JUMP
mhl_vs:
    // q2, vlen, astart, rlp_pos, ptr, ret
    %stack (q2, vlen, astart) -> (@SEGMENT_TRIE_ENCODED_CHILD, q2, @SEGMENT_TRIE_ENCODED_CHILD, astart, vlen, mhl_cp, q2, vlen)
    PUSH mem_copy
    JUMP
mhl_cp:
    // q2, vlen, rlp_pos, ptr, ret
    ADD
    %stack (q3, rlp_pos, ptr) -> (rlp_pos, q3)
    PUSH mpt_finish_node
    JUMP

// (rlp_pos, ptr, ret) -> (root): top-level calc_hash — a HASH node
// passes its digest through, a big node's c() already IS the keccak,
// a small encoding gets keccak'd here
GLOBAL mpt_hash_root:
    %stack (rlp_pos, ptr) -> (rlp_pos, ptr, mhr_node, rlp_pos)
    PUSH mpt_hash_node
    JUMP
mhr_node:
    // payload, blen, rlp_pos, ret
    DUP2
    PUSH 32
    EQ
    PUSH mhr_is32
    JUMPI
    %stack (payload, blen, rlp_pos) -> (rlp_pos, 9, payload, blen)
    ADD
    // ps, payload, blen, ret
    %stack (ps, payload, blen) -> (@SEGMENT_TRIE_ENCODED_CHILD, payload, ps, blen, mhr_stored, ps, blen)
    PUSH store_be
    JUMP
mhr_stored:
    // ps, blen, ret
    %stack (ps, blen) -> (0, @SEGMENT_TRIE_ENCODED_CHILD, ps, blen)
    KECCAK_GENERAL
    %stack (d) -> (d, mhr_swapped)
    PUSH u256_byteswap
    JUMP
mhr_swapped:
    // root, ret
    SWAP1
    JUMP
mhr_is32:
    %stack (payload, blen, rlp_pos, ret) -> (ret, payload)
    JUMP

// (ret) -> (root): hash the loaded tries via their GlobalMetadata root
// pointers (spec tests/mpt/hash.rs test_state_trie)
GLOBAL mpt_hash_state_trie:
    PUSH 0
    %mpt_schema_store
    %gmload(4)
    %stack (p) -> (0, p)
    PUSH mpt_hash_root
    JUMP

GLOBAL mpt_hash_txn_trie:
    PUSH 2
    %mpt_schema_store
    %gmload(5)
    %stack (p) -> (0, p)
    PUSH mpt_hash_root
    JUMP

GLOBAL mpt_hash_receipt_trie:
    PUSH 2
    %mpt_schema_store
    %gmload(6)
    %stack (p) -> (0, p)
    PUSH mpt_hash_root
    JUMP


// (key, value_ptr, ret) -> (): insert under a full 64-nibble key and
// update the state-trie root pointer (spec: tests/{balance,
// account_code}.rs prepare_interpreter)
GLOBAL mpt_insert_state_trie:
    %gmload(4)
    %stack (root, key, vptr) -> (root, 64, key, vptr, mist_done)
    PUSH mpt_insert
    JUMP
mist_done:
    // new_root, ret
    %gmstore(4)
    JUMP
"""
