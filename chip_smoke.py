"""Drive the PyTorch/CUDA port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

The main paths are the rounds of the flagship proof (the hash-tree circuit,
234 wires, 2^18 rows, rate_bits 3, cap height 4, no blinding) and the
whole proof after the witness:

* the wires commitment: PolynomialBatch.from_values on the 234 x 2^18
  witness (IFFT -> coset LDE in leaf order -> Poseidon leaf hash -> Merkle
  levels), then 28 query openings from the device-resident tree;
* the quotient round (plonk/prover.py:quotient_round): partial products ->
  Z/PP commitment -> the compiled constraint program over the 2^21-point
  quotient coset -> coset INTT -> quotient commitment, plus the Z/PP
  polynomials' natural-order coset LDE (ops/ntt.py:lde_coset_ntt), with
  its challenges drawn from the port's transcript (iop/challenger.py);
* the opening round (plonk/prover.py:opening_round, phases 7-8): zeta, the
  opening set of the four oracles' 354 polynomials, the FRI composition
  over the 2^21-point LDE, four fold layers of arity 16, the proof of work
  (16 bits) and 28 query rounds, on the two rounds' commitments, through
  the fused FRI (its transcript on the card: kernel K9, the grind K8 on
  its state), held equal to the layered FRI's proof;
* the whole proof after the witness (plonk/prover.py:prove, phases 2-8),
  from the same witness, and at 2^9 rows the card's proof against the one
  the same machine makes with device="cpu";
* the port's entry points on the real flagship circuit (phase 9b):
  CircuitBuilder.build of the 2^17-leaf hash tree (models/hash_tree.py;
  its constants-sigmas commitment on the card), its circuit digest, cap
  and root held equal to the JAX package's pinned circuit
  (plonk/programs/hash_tree_wide_ecc_k17.json), then
  ProverSession (its quotient program compiled by the session and held
  equal to plonk/programs/hash_tree_wide_ecc.npz) and ProverSession.prove
  (cold and warm), whose witness the device witness
  plan generates on the card (iop/device_witness.py; kernel K7 runs its
  18 Poseidon waves in one launch), the plan's witness held equal to the
  host engine's,
  every proof equal to the pinned flagship proof (sha256), and the port's
  verifier on every proof and on a corrupted copy; the FRI's transcript
  and proof-of-work grind of every proof run on the card (K9, K8);
* the same tree under standard_recursion_config (phase 9c: 135 wires,
  2^18 rows, its program compiled, the device witness), proved cold and
  warm and verified, every proof the pinned STANDARD_PROOF_SHA256, which
  the JAX package's verifier accepts;
* the gate mix (phase 9d, models/gate_mix.py: every gate of plonky2's
  recursion set, 2^12 rows, standard_recursion_config), whose witness the
  host engine generates (the device plan refuses it), proved and
  verified, every proof the pinned GATE_MIX_PROOF_SHA256 of the port's
  CPU proof;
* the four-table EVM proof (phase 9e, evm/prover.py:prove_all): 640
  Keccak sponge operations (evm/workload.py), their keccak, sponge, logic
  and memory tables (2,481 x 2^14, 414 x 2^10, 523 x 2^12, 21 x 2^16)
  joined by live cross-table lookups, each table's quotient program
  compiled once and run on K6, under StarkConfig.standard_fast_config();
  proved cold and warm (every proof the pinned EVM_PROOF_SHA256),
  verified once by the port's verifier, which rejects a copy with one
  opened value flipped; then the tests' two sponge ops, whose proof on
  the card equals the port's CPU proof (EVM_SMALL_PROOF_SHA256, which the
  CPU tests hold equal to the JAX package's);
* the Fibonacci STARK at 2^20 rows (phase 9f, stark/prover.py:prove, its
  permutation argument included), proved cold and warm and verified;
* System Zero at its 2^16 rows (phase 9g, system_zero/system_zero.py: 558
  columns, 22 lookups, its program of 7,865 ops on K6) under
  standard_fast_config, proved cold and warm (pinned
  SYSTEM_ZERO_PROOF_SHA256), verified, a flipped opening rejected;
* recursion (phase 9h, models/bench_recursion.py) under
  standard_recursion_config: the no-op proof of 2^16 rows, the proof that
  verifies it and the proof that verifies that one (host witness), each
  through ProverSession cold and warm, verified and pinned
  (RECURSION_PROOF_SHA256, the port's CPU proofs); the double proof
  compressed and restored byte for byte; then three links of the cyclic
  Poseidon hash chain (models/cyclic_hash_chain.py) under the JAX
  package's test config for it, each verified, its public inputs the
  iterated host Poseidon;
* recursive aggregation under standard_recursion_config (phases 9i-9j):
  the Fibonacci STARK's 2^20-row proof verified in a circuit
  (stark/recursive_verifier.py) and the 640-op EVM proof's four tables
  each in a circuit of its own (evm/recursive_verifier.py:
  recursive_stark_circuit, wrap_table_proof, wrap_all_proof), every
  wrapper proved and pinned, the aggregate check; a tree of recursion of depth 2
  (plonk/tree_recursion.py: four leaves, two nodes, the root);
* the U32, comparison and permutation gate set (phase 9k,
  models/gate_set.py): sorted memory operations, a permutation,
  insertions and u32 arithmetic filling 2^14 rows under
  standard_ecc_config, proved, pinned to the port's CPU proof, a
  non-permutation refused;
* secp256k1 ECDSA verification in a circuit (phase 9l,
  models/ecdsa_verify.py: the big-integer, non-native and curve gadgets,
  98,660 gates, 2^17 rows under standard_ecc_config), built on the card,
  proved through ProverSession (host witness), pinned, the signature
  checked natively, a changed opening refused;
* the EVM's 256-bit arithmetic table with its 16-bit range check (phase
  9m, evm/arithmetic.py: 41,692 ops in 2^16 rows, 237 columns, 48
  lookups) under standard_fast_config, each output held against its
  Python int, proved, pinned to the port's CPU proof, a wrong product and
  a limb of 2^16 refused;
* the zkEVM's block proof (phase 9n, evm/block.py): the block kernel
  assembled (its code the JAX package's), tests/test_evm_transfer.py's
  signed transfer executed on the host with the sender recovered in the
  kernel (the CPU table 130 x 2^19, memory 21 x 2^21, the range-checked
  arithmetic table 237 x 2^16; each of the six traces the JAX
  package's, by sha256), the state root after the block the hand-built
  trie's, proved through prove_block_traces (pinned to the card's proof),
  verified, one opened value of the CPU table flipped and refused.
  Phases 9c-9n run EARLIER_WARM_RUNS warm proofs.

The script builds the kernels from csrc/ with nvcc (one process per
source, in parallel), holds each kernel, in each of its forms (K3 and K5
down the columns and along the rows; K6 on the flagship's program, the
gate mix's, one of more slots than shared memory holds, the EVM keccak
table's, System Zero's, the single-recursion circuit's, the wrappers',
the gate set's, the ECDSA circuit's, the arithmetic table's and the
block's CPU table's), against
its plain PyTorch version on the card (exact equality: integer
arithmetic, tolerance 0), runs each path
at full width with its launch counts set to 0 just before and read just
after, holds the full-width results against the plain versions on subsets,
verifies the openings and every FRI query path, and prints one JSON line
with each TPU kernel's launches, time and bound, split by form and by
path, and the Merkle levels (K2) of the commitment and of the FRI layer
trees launch by launch.  Every phase prints a flushed line
before it starts and when it ends; any failure raises and exits non-zero.
The last line of standard output is the run's device summary.

It also times K2's narrow levels and K7's 18 waves one launch each
against one launch (phases 3b and 3c), traces one warm commitment,
quotient round, opening round and proof with torch.profiler and prints
the device's busy and idle shares of each, times the stages of the
opening round and of the proof and the host transcript's permutations,
and (the last phase) measures the card's rate of
independent 32-bit multiplies in four instruction forms and counts the
multiply instructions of one field product in the SASS
(plonky2_tpu_torch/csrc/probes/).

It imports nothing of JAX or of the JAX package, needs one card, and writes
nothing outside the kernels' build directory.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

T0 = time.perf_counter()

# Main path: the wires commitment of the hash-tree circuit under
# CircuitConfig.wide_ecc_config() (234 wires, 2^18 rows, rate 3, cap 4).
NUM_POLYS = 234
NUM_WIRES = NUM_POLYS
LOG_N = 18
RATE_BITS = 3
CAP_HEIGHT = 4
NUM_QUERIES = 28
WARM_RUNS = 3
SEED = 0
# The quotient round: the flagship circuit's compiled quotient program and
# its dimensions, carried over from the JAX compiler as data.
PROGRAM_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "plonky2_tpu_torch", "plonk", "programs",
                            "hash_tree_wide_ecc.npz")
QUOTIENT_CHUNK = 1 << 21        # lanes per K6 launch (sweep below, PERF.md)
# The opening round: the flagship FRI config (plonky2_tpu/plonk/config.py:
# 9-12, proof of work 16 bits, constant arity 2^4 down to 2^5
# coefficients), a seeded circuit digest and public inputs read from
# these witness cells (wire, row).
POW_BITS = 16
ARITY_BITS = 4
FINAL_POLY_BITS = 5
PUBLIC_INPUT_WIRES = ((0, 0), (1, 0), (2, 0), (3, 0))
REDUCED_LOG_N = 9               # the card-vs-CPU proof
# the flagship circuit built by the port (phase 9b): 2^17 leaves, 2^18 rows;
# its proof from random.Random(0), as every build of the port since it
# first proved the flagship has made it
FLAGSHIP_PROOF_SHA256 = ("d3654cf0751d606f8cd0f5143e6d2ab447cbeee73c07aa59768"
                         "08c9728ec749d")
SESSION_LOG2_LEAVES = 17
# the same tree under standard_recursion_config (phase 9c), proved from
# random.Random(0); the JAX package's verifier accepts this proof against
# the port's constants-sigmas cap (scripts/jax_verify_flagship_proof.py
# --config standard).  The JAX package's build of this tree is pinned at
# 2^10 leaves only (STANDARD_REF), which phase 9c holds the port's build
# of that size on the card against.
STANDARD_PROOF_SHA256 = ("532aeedc23471aed748b033eeffd86758c8bd83c495db1f4c"
                         "350163d1d1d6de8")
# the gate mix (phase 9d): 290 copies fill 2^12 rows; its proof from
# random.Random(0), as the port proves it on the CPU
GATE_MIX_COPIES = 290
GATE_MIX_LOG_N = 12
GATE_MIX_PROOF_SHA256 = ("1f94b80e3c312d204db6d8818a62b17e0046440661a748d670c"
                         "3d854683ca01d")
# The four-table EVM proof (phase 9e): EVM_OPS Keccak sponge operations
# of plonky2_tpu_torch/evm/workload.py:sponge_ops (numpy seed 0), keccak
# 2,481 x 2^14, sponge 414 x 2^10, logic 523 x 2^12, memory 21 x 2^16,
# under StarkConfig.standard_fast_config(); every proof this one
EVM_OPS = 640
EVM_LOG_ROWS = (14, 10, 12, 16)
EVM_PROOF_SHA256 = ("da4a0ff13091ddfbc229f8906d97b56621179447b358416117"
                    "884e18ce72e68e")
# the tests' two sponge ops under tests/test_stark.py:make_config: the
# port's CPU proof, which tests/test_torch_evm.py holds equal to the JAX
# package's and pins to the same digest
EVM_SMALL_PROOF_SHA256 = ("9eca99ad915b77371d03b13fb57f0ec47f24adc58ac417c47"
                          "96b69e4faa13857")
# the Fibonacci STARK (phase 9f) at 2^FIB_LOG_N rows under
# standard_fast_config, from x0 = 0, x1 = 1
FIB_LOG_N = 20
FIB_PROOF_SHA256 = ("5be337084bbc260f2a58397f493863fa7112977d7a9bafef41"
                    "ab125b40249534")
# System Zero (phase 9g) at its MIN_TRACE_ROWS = 2^16 rows (558 columns)
# under standard_fast_config, public inputs [0, 0]: the port's CPU proof
# (scripts/port_system_zero_proof.py --device cpu)
SYSTEM_ZERO_PROOF_SHA256 = ("4dc1f0cdcbaa16cb3072ad14a55fd0c7f8d4c0b6fad7a"
                            "44b6e47dbbea17c2873")
# The recursion chain (phase 9h, models/bench_recursion.py) under
# standard_recursion_config: the no-op circuit of 2^RECURSION_INNER_LOG
# rows, the circuit that verifies its proof and the circuit that verifies
# that one, each proof from random.Random(0); their serialized proofs'
# sha256 as the port makes them on the CPU (scripts/port_recursion_proof.py
# --device cpu; scripts/jax_verify_recursion_proof.py checks the double
# one with the JAX package's builder and verifier)
RECURSION_INNER_LOG = 16
RECURSION_PROOF_SHA256 = {
    "dummy": ("3782b7b6b49b3f93e1870eeb9102e175f885650d13db87854483dd71df"
              "1317cd"),
    "single": ("c23b432a14500461c1343e94d0f07e155c9c1a35f2951007819a5dbf33"
               "56fa99"),
    "double": ("03f8ab65c73482b3c0c40b1ed27de59d9b15472bda5c7e678024369ce0"
               "03877d"),
}
# the cyclic Poseidon hash chain (models/cyclic_hash_chain.py): its links,
# under the JAX package's test config (fast_recursion_config; 2^13 rows).
# Under standard_recursion_config the cycle's constants all fit the spare
# constant slots of its RandomAccessGate of 4 bits, so its gate set has no
# ConstantGate, and dummy_circuit refuses the common data (the JAX
# package's dummy_circuit does the same).
CYCLIC_STEPS = 3
CYCLIC_INITIAL = [0, 1, 2, 3]
# Recursive aggregation (phases 9i-9j) under standard_recursion_config,
# each proof from random.Random(0) unless said otherwise.  Phase 9i wraps
# phase 9f's Fibonacci STARK proof in a circuit (its proof the port's CPU
# proof, scripts/port_aggregation_proofs.py --device cpu) and phase 9e's
# EVM proof in one circuit a table (the memory table's proof the port's
# CPU proof of the card's EVM proof, the others the card's).
WRAP_FIB_PROOF_SHA256 = ("84fbb9087b6f28e49bad7275389561f4544dbd5809c17f05"
                         "dc4bc927bf4b1a3c")
EVM_WRAPPER_PROOF_SHA256 = {
    "KeccakStark": ("17e12cb6286b14a18309b99f922bc9b0252f466a4d228de70f0764"
                    "e7d68ba5bc"),
    "KeccakSpongeStark": ("4385dc7ca2b14e1776310e479972e4831fc5024b5839ba98"
                          "b620c70d7258a89a"),
    "LogicStark": ("fb95ca478a359a12cb32b7f9ba312bec4400d24a00258b851122295f"
                   "a255e51a"),
    "MemoryStark": ("e133d2603afdfa381874feee4dcccdcc2ebb582df212eb51458766"
                    "2c9c9940b2"),
}
# Phase 9j: tests/test_tree_recursion.py's tree over the Fibonacci circuit
# of models/fibonacci.py, its common data common_data_for_recursion(config,
# 5, 2): the inner proof, four leaves (leaf i from random.Random(i)), two
# nodes over them (random.Random(4 + j)) and the root (random.Random(6)),
# the card's proofs
TREE_PROOF_SHA256 = {
    "inner": ("dfe7821b65a0dbf61459909e25621a19f184842c41c1153b3299994c466"
              "47656"),
    "leaf": [("e72557a31cafbc5b03983297ed8cc97169161dda353bdfa06d771f40466"
              "73652"),
             ("aed474eff54111b8ec43f1b2a082adce8d7ad180e3a49edea06fd08da18"
              "2f7a9"),
             ("dd1557ce9649857a230409495c0e1ca826dd2531b87c07b3fa3cb2d988a"
              "4bd76"),
             ("8e9a5a31a444db5862bb2a1d007f1ddc2860f4513337b9bbfcdcf1763ec"
              "215b3")],
    "node": [("ce3721a2c2749c594a131170fbb6c24e41ae0e90bcfb69d4f5060c12047"
              "58ca8"),
             ("3bbb06fea8d3d85da99fe4daeecb01d366b97e7f2d2578a44550f37e952"
              "7df25")],
    "root": ("b4a7eca19387ee3602ebace1f36f559a2b23c1287bca13bc660b60a16cdf"
             "ca08"),
}
# Phase 9k: the U32, comparison and permutation gate set of
# models/gate_set.py under standard_ecc_config (136 wires), at its
# default sizes (2^14 rows); its proof the port's CPU proof
# (scripts/port_aggregation_proofs.py --device cpu)
GATE_SET_PROOF_SHA256 = ("66189c9cff009594109362e33c16762c29a0ac1334defcc7"
                         "ee1b2f2e3f783b2b")
# Phase 9l: tests/test_ecdsa_verify.py's secp256k1 ECDSA verification
# (models/ecdsa_verify.py, 256-bit scalars) under standard_ecc_config:
# 98,660 gates placed, 2^17 rows; its proof from random.Random(0) is the
# card's (the port's CPU build commits 2^20 LDE rows with the plain
# versions for many minutes), which the warm run and a second call repeat
ECDSA_PROOF_SHA256 = ("d7cb0b755eb6d52f4db6a15f705ca5161a193f0699f24260406c4"
                      "6c6753ed340")
# Phase 9m: ArithmeticStark(range_check=True) on evm/workload.py:
# arithmetic_ops() (41,692 ops in 65,516 of 2^16 rows, 237 columns) under
# standard_fast_config; its proof the port's CPU proof
# (scripts/port_ecdsa_arithmetic_proofs.py --device cpu --parts
# arithmetic)
ARITHMETIC_PROOF_SHA256 = ("a7ce359735ca320d316ad27c01409f62d19f7509e8480fd5"
                           "27372d157ece7986")
# Phase 9n: the block of tests/test_evm_transfer.py's signed transfer
# (evm/workload.py:transfer_inputs, upstream transfer_to_new_addr.rs)
# with the sender recovered in the kernel and the arithmetic table's
# range check on, under standard_fast_config.  The block kernel's code
# (sha256) and code hash, and each of the six traces' (rows, columns,
# sha256 of its uint64 bytes), are the JAX package's
# (scripts/jax_block_pins.py on the CPU); the proof is the card's (a CPU
# proof at this size is impractical), which the warm run and a second
# call repeat
BLOCK_KERNEL_SHA256 = ("78fe242e5a6541334ebd52805f7154bfd43e122147f87bcb49"
                       "1e622ff47b0146")
BLOCK_CODE_HASH = ("1af22362e1870e400095c60617e4d7e16adbb23efd76b85ec81c2"
                   "ba0ac226dc1")
BLOCK_TRACES = (
    (130, 524288,
     "c97f4f7a3a9792fe52ce5701ccb5129d86ad92723a61fb32b6e0a027a1fddb5f"),
    (2481, 4096,
     "c3a9744e096cf224ed6ea0e35c2a50b754f340fb6e10981f0cba50143e8dc2bd"),
    (414, 128,
     "77fdfea1c255ace59f63cba953ae72b4cac1e1c6d4982001edce59d1117ab913"),
    (523, 2048,
     "1baa77d9f6a9656eb271e896d4382782c5aee18c602235745fe463e5bd0835ca"),
    (21, 2097152,
     "dbe09279378c7df71742093d67677b868cbe589e355a2914eb447946a4cf1f4f"),
    (237, 65536,
     "b111e27d1440d4ebed7539199ae80c570dcc892ea8532be69c27573263116038"),
)
BLOCK_PROOF_SHA256 = ("96082f90cf18f7e8c63c3350116e4ec945c0589ceb2e3e8a757"
                      "9a9c6a099c3f8")
# phases 9c-9n run fewer warm proofs than the others, which keeps the
# whole script inside its time limit since 9g-9k came
EARLIER_WARM_RUNS = 1
# the TPU kernels each STARK path must launch (K4 and K7 where they do)
STARK_KEYS = ("K1", "K2", "K3", "K5", "K6", "K8", "K9")
FLAGSHIP_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "plonky2_tpu_torch", "plonk", "programs",
                            "hash_tree_wide_ecc_k17.json")
STANDARD_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "plonky2_tpu_torch", "plonk", "programs",
                            "hash_tree_standard_k10.json")
CHECK_POINTS = 8
CHUNK_SWEEP = [1 << k for k in range(15, 22)]
CHECK_LANES = 4096
K6_TIMING_LANES = 1 << 16       # K6's programs timed at this width
# K2's narrow top of a 2^21-leaf tree with cap 4: the 11 levels of 2^14
# down to 16 parents (phase 3b)
NARROW_LEVELS = 11
NARROW_REPS = 5

# Published H100 SXM peaks (NVIDIA data sheet; CUDA C Programming Guide,
# arithmetic instruction throughput for compute capability 9.0: 64 32-bit
# integer multiply-adds and 64 64-bit floating-point multiply-adds per
# clock per SM; 132 SMs at the 1.98 GHz boost clock).  All assume the full
# 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 132 * 64 * 1.98e9
FP64_FMAS_PER_S = 132 * 64 * 1.98e9

# The products one Poseidon permutation needs, counted on the fast
# partial-round schedule (plonky2's mds_partial_layer_init/_fast), the
# cheapest known for this function, in the forms K1/K2 compute them: 8 full
# rounds of 12 x^7 S-boxes and the dense 12x12 MDS, whose small
# coefficients take one product per 32-bit half of a word (144 x 2); one
# dense 11x11 layer of full field constants before the partial rounds; 22
# partial rounds of one S-box and a sparse layer (22 products by full field
# constants, one by a small one).  A 64x64 product is four 32x32->64
# products and a square three, so an x^7 S-box (x^2, x^3 = x^2 x,
# x^4 = (x^2)^2, x^3 x^4) is 3 + 4 + 3 + 4.  K1/K2 run the full rounds' MDS
# as exact float64 multiply-adds on the FP64 pipe and every other product
# on the integer pipe; the two pipes issue side by side, so the operation
# bound is the larger of their two times.
#
# Each 32x32->64 product counts as one result of the throughput table's row
# "32-bit integer multiply, multiply-add, extended-precision multiply-add"
# (one IMAD.WIDE.U32 instruction), each float64 multiply-add as one of the
# row "64-bit floating-point add, multiply, multiply-add".  These are the
# fewest instructions the products can take, so the bound stays a floor;
# phase 8 measures the rate at which the wide integer forms really issue.
FIELD_MUL_MULS = 4     # one 64x64 -> 128 product
FIELD_SQUARE_MULS = 3  # one 64-bit square
_SBOX_MULS = 2 * FIELD_SQUARE_MULS + 2 * FIELD_MUL_MULS
PERM_MULS = (8 * 12 * _SBOX_MULS + 11 * 11 * FIELD_MUL_MULS
             + 22 * (_SBOX_MULS + 22 * FIELD_MUL_MULS + 2))
PERM_FP64_FMAS = 8 * 144 * 2

# The TPU kernels, each one row of the kernels line: key -> (name, the
# JAX function it replaces).
TPU_KERNELS = {
    "K1": ("K1 hash_leaves_cols", "plonky2_tpu/hash/poseidon_pallas.py:401"),
    "K2": ("K2 compress_level", "plonky2_tpu/hash/poseidon_pallas.py:473"),
    "K3": ("K3 ntt_cols", "plonky2_tpu/ops/ntt_pallas.py:95"),
    "K4": ("K4 ntt_cols_zero_tail", "plonky2_tpu/ops/ntt_pallas.py:141"),
    "K5": ("K5 ntt_cols_dif", "plonky2_tpu/ops/ntt_pallas.py:243"),
    "K6": ("K6 constraint_program",
           "plonky2_tpu/plonk/constraint_program.py:459"),
    # port-only: the JAX package computes these in XLA, with no Pallas
    # kernel
    "K7": ("K7 poseidon_wires (port-only)",
           "plonky2_tpu/hash/poseidon_wires_jax.py:153"),
    "K8": ("K8 pow_grind (port-only)",
           "plonky2_tpu/fri/device_prover.py:447"),
    "K9": ("K9 sponge (port-only)",
           "plonky2_tpu/iop/challenger_jax.py:32"),
}
NTT_CU = "plonky2_tpu_torch/csrc/ntt.cu"
KERNELS = {
    # C entry -> (TPU kernel, form, source)
    "plk_hash_leaves": ("K1", "hash_leaves_cols",
                        "plonky2_tpu_torch/csrc/poseidon.cu"),
    "plk_compress_level": ("K2", "compress_level",
                           "plonky2_tpu_torch/csrc/poseidon.cu"),
    "plk_compress_tail": ("K2", "compress_tail (narrow top, one launch)",
                          "plonky2_tpu_torch/csrc/poseidon.cu"),
    "plk_ntt_cols_dit": ("K3", "ntt_cols", NTT_CU),
    "plk_ntt_rows_dit": ("K3", "ntt_rows (stored transposed)", NTT_CU),
    "plk_ntt_cols_zero_tail": ("K4", "ntt_cols_zero_tail", NTT_CU),
    "plk_ntt_cols_dif": ("K5", "ntt_cols_dif", NTT_CU),
    "plk_ntt_rows_dif": ("K5", "ntt_rows_dif (in place)", NTT_CU),
    "plk_constraint_program": ("K6", "constraint_program",
                               "plonky2_tpu_torch/csrc/constraint_program.cu"),
    "plk_poseidon_wires_waves": ("K7", "poseidon_wires_waves (a run of "
                                 "waves, one launch)",
                                 "plonky2_tpu_torch/csrc/poseidon.cu"),
    "plk_pow_grind": ("K8", "pow_grind", "plonky2_tpu_torch/csrc/poseidon.cu"),
    "plk_sponge": ("K9", "sponge (the transcript's duplex sponge)",
                   "plonky2_tpu_torch/csrc/poseidon.cu"),
}
# the kernels each main path runs
COMMIT_PATH = ("plk_hash_leaves", "plk_compress_level", "plk_compress_tail",
               "plk_ntt_cols_dit", "plk_ntt_rows_dit", "plk_ntt_cols_dif",
               "plk_ntt_rows_dif")
QUOTIENT_PATH = tuple(e for e in KERNELS if e not in (
    "plk_poseidon_wires_waves", "plk_pow_grind", "plk_sponge"))
# the opening round's FRI runs its transcript on the card (K9) and grinds
# its proof of work there (K8)
FRI_PATH = ("plk_pow_grind", "plk_sponge")
OPENING_PATH = COMMIT_PATH + FRI_PATH
# a proof does not run K4: the quotient gathers its inputs from the
# commitments' leaves; phase 6 runs the natural-order LDE beside the round
PROVE_PATH = tuple(e for e in QUOTIENT_PATH
                   if e != "plk_ntt_cols_zero_tail") + FRI_PATH
# the session's proof generates its witness too (K7)
SESSION_PATH = PROVE_PATH + ("plk_poseidon_wires_waves",)
# the gate mix's proof (2^12 rows): its witness from the host engine, and
# every Merkle level at most 2^14 parents wide, so each tree is one narrow
# top (K2's tail form) with no wide level
GATE_MIX_PATH = tuple(e for e in PROVE_PATH if e != "plk_compress_level")
# the flagship witness plan's Poseidon waves, 2^16 rows down to 1, then the
# public inputs' hash (phase 3c)
FLAGSHIP_WAVES = tuple(1 << k for k in range(16, -1, -1)) + (1,)


def kernel_label(entry: str) -> str:
    key, form, _ = KERNELS[entry]
    return f"{key} {form}"


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


class phase:
    """Prints a line when a phase starts and when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        log(f"phase {self.name}: start")
        return self

    def __exit__(self, exc_type, exc, tb):
        state = "done" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"phase {self.name}: {state} in "
            f"{time.perf_counter() - self.t:.1f} s")
        return False


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rand_field(rng, shape, dev):
    """Canonical field elements drawn by numpy, as an int64 tensor."""
    from plonky2_tpu_torch.field.convert import from_u64
    from plonky2_tpu_torch.field.goldilocks import P
    return from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), dev)


BOUNDARY = [0, 1, (1 << 32) - 1, 1 << 32, (1 << 64) - (1 << 32)]  # p - 1 last


def boundary_field(rng, shape, dev):
    from plonky2_tpu_torch.field.convert import from_u64
    vals = np.array(BOUNDARY, dtype=np.uint64)
    return from_u64(vals[rng.integers(0, len(vals), size=shape)], dev)


def flat(x):
    """A tensor, or a list of tensors (K2's narrow top) as one."""
    import torch
    if isinstance(x, list):
        return torch.cat([t.reshape(-1) for t in x])
    return x


def max_abs_err(a, b) -> int:
    """Largest |a - b| over the u64 values of two int64 tensors."""
    from plonky2_tpu_torch.field.convert import to_u64
    x, y = to_u64(a).reshape(-1), to_u64(b).reshape(-1)
    check(x.shape == y.shape, f"shapes {a.shape} vs {b.shape}")
    d = np.maximum(x, y) - np.minimum(x, y)
    return int(d.max()) if d.size else 0


def cuda_ms(fn, warmup: bool = True):
    """Milliseconds of one fn() on the card (CUDA events), after one
    untimed warm-up call when asked."""
    import torch
    if warmup:
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


class KernelRecorder:
    """Wraps kernels.call to time every launch with CUDA events and keep
    its arguments (for the bound), without touching the launch counts."""

    def __init__(self):
        from plonky2_tpu_torch import kernels
        self.kernels = kernels
        self.orig = kernels.call
        self.records = []

    def __enter__(self):
        import torch

        def timed(name, *args):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            self.orig(name, *args)
            e.record()
            self.records.append((name, args, s, e))
        self.kernels.call = timed
        return self

    def __exit__(self, *exc):
        self.kernels.call = self.orig
        return False

    def ms_by_kernel(self) -> dict:
        import torch
        torch.cuda.synchronize()
        out = {}
        for name, _, s, e in self.records:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out


def launch_cost(name: str, args, pow_witness=None) -> tuple:
    """(bytes, int32 multiplies, float64 multiply-adds) that one launch's
    work needs at least: each input read once, each output written once.
    K8's work depends on the data: the permutations from its start to the
    witness it found (`pow_witness`, which its run's proof holds)."""
    from plonky2_tpu_torch.kernels import named_args
    a = named_args(name, args)
    if name == "plk_hash_leaves":
        L, N = a["L"], a["N"]
        perms = N * -(-L // 8)
        return (8 * (L * N + 4 * N), perms * PERM_MULS,
                perms * PERM_FP64_FMAS)
    if name == "plk_compress_level":
        m = a["m"]
        return 8 * (8 * m + 4 * m), m * PERM_MULS, m * PERM_FP64_FMAS
    if name == "plk_compress_tail":
        # its first level's children in, every level's parents out
        parents = tail_parents(a["m0"], a["n_levels"])
        return (8 * (8 * a["m0"] + 4 * parents), parents * PERM_MULS,
                parents * PERM_FP64_FMAS)
    if name == "plk_poseidon_wires_waves":
        # a row's 13 inputs (values and indices) read and 122 wires
        # (values and indices) written; its permutation and 4 deltas.  The
        # run covers its R index columns (the plan's runs do).
        G = a["R"]
        return (G * (8 + 4) * (13 + 122) + 8 * (a["n_waves"] + 1),
                G * (PERM_MULS + 4 * FIELD_MUL_MULS), G * PERM_FP64_FMAS)
    if name == "plk_pow_grind":
        # the 12 words read and the witness written (twice on the
        # sponge); one permutation for each candidate from start up to the
        # witness
        check(pow_witness is not None, "K8's bound needs its witness")
        perms = pow_witness - a["start"] + 1
        return (8 * 12 + 8 * (2 if a["slot"] else 1), perms * PERM_MULS,
                perms * PERM_FP64_FMAS)
    if name == "plk_sponge":
        # the buffer read and written, the words absorbed, the draws (and
        # indices) and powers written; the permutations its buffering needs
        from plonky2_tpu_torch.hash.poseidon_cuda import (SPONGE_WORDS,
                                                          sponge_lengths)
        words = a["rows"] * a["cols"]
        perms = sponge_lengths(a["n_in"], a["n_out"], words,
                               a["n_draws"])[2]
        nbytes = 8 * (2 * SPONGE_WORDS + words + a["n_draws"]
                      * (2 if a["idx"] else 1) + 2 * a["arity"])
        return nbytes, perms * PERM_MULS, perms * PERM_FP64_FMAS
    if name == "plk_constraint_program":
        # the linear form's 64x64 products on every lane; the input rows it
        # reads read once and its outputs written once, plus its op stream,
        # index arrays and scalar bank
        from plonky2_tpu_torch.plonk.constraint_program import MUL_OPS
        check(a["ops"] in K6_PROGRAMS, "K6 ran a program no phase noted")
        lin = K6_PROGRAMS[a["ops"]]            # the program that ran
        check((a["n_ops"], a["n_slots"]) == (lin.n_ops, lin.n_slots),
              "K6's launch and its linear form disagree")
        C, n_out = a["C"], a["n_out"]
        n_mul = int(np.isin(lin.fields()["opcode"], MUL_OPS).sum())
        nbytes = (8 * (lin.n_read + n_out) * C + 8 * lin.n_ops
                  + 4 * (lin.n_read + n_out) + 8 * a["bank_size"])
        return nbytes, n_mul * FIELD_MUL_MULS * C, 0
    B = a["B"]
    post = a.get("post") is not None
    if name.startswith("plk_ntt_rows"):
        # size-n2 transforms of the B * n1 rows; K3's takes a post table
        rows, n2 = B << a["log_n1"], 1 << a["log_n2"]
        nbytes = 8 * (2 * rows * n2 + n2 + ((rows // B) * n2 if post else 0))
        muls = rows * (n2 // 2) * a["log_n2"] + (rows * n2 if post else 0)
        return nbytes, muls * FIELD_MUL_MULS, 0
    pre = a["pre"] is not None
    # column NTTs of n1 = 2^log_n1 rows from a prefix of q rows (K3: all
    # n1).  With Q = q rounded up to a power of two and r = log2(n1 / Q), the
    # first r stages of a zero tail scale n1 - Q prefix copies, then each
    # of the 2^r segments is a Q-point DIF.
    n2, log_n1 = a["n2"], a["log_n1"]
    n1 = 1 << log_n1
    q = a.get("q", n1 >> a.get("rate_bits", 0))
    log_q = max(0, (q - 1).bit_length())
    nbytes = 8 * (B * q * n2 + B * n1 * n2 + (1 << log_q)
                  + (n1 if log_q < log_n1 else 0)
                  + (q * n2 if pre else 0) + (n1 * n2 if post else 0))
    muls = B * n2 * ((n1 // 2) * log_q + (n1 - (1 << log_q))
                     + (q if pre else 0) + (n1 if post else 0))
    return nbytes, muls * FIELD_MUL_MULS, 0


def tail_parents(m0: int, n_levels: int) -> int:
    """The nodes (permutations) of K2's narrow top from m0 parents."""
    return sum(m0 >> k for k in range(n_levels))


# the linear form of each program that a counted path runs on K6, by the
# device address of its op stream (the `ops` argument of K6's launches)
K6_PROGRAMS = {}


def note_program(prog, dev) -> None:
    """Note `prog`'s linear form for launch_cost, before a path runs it
    on `dev` (the wrapper keeps a program's op stream on the device, so
    its launches pass this address)."""
    import torch
    from plonky2_tpu_torch.plonk.constraint_program import linearize
    from plonky2_tpu_torch.plonk.constraint_program_cuda import \
        device_program
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        # the wrapper keys its cache by the inputs' device, which has one
        dev = torch.device("cuda", torch.cuda.current_device())
    K6_PROGRAMS[device_program(prog, str(dev))[0].data_ptr()] = \
        linearize(prog)


@functools.lru_cache(maxsize=1)
def flagship_program():
    """(ConstraintProgram, CircuitShape) of the flagship circuit."""
    from plonky2_tpu_torch.plonk import constraint_program as cp
    return cp.load(PROGRAM_PATH)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device(dev):
    import torch
    smi = nvidia_smi_line()
    print(smi, flush=True)
    log(f"device {torch.cuda.get_device_name(dev)}; torch {torch.__version__}; "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    return smi


def phase_build() -> float:
    from plonky2_tpu_torch import kernels
    info = kernels.build()
    kernels.library()
    for line in info["log"].splitlines():
        if "registers" in line or "bytes stack" in line or "Compiling" in line:
            log("ptxas: " + line.strip())
    log(f"nvcc seconds: {info['seconds']:.1f} ({info['path']})")
    return info["seconds"]


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at reduced shapes, exactly.
    Returns per kernel: max_abs_err, and kernel/plain ms at one shape."""
    from plonky2_tpu_torch.hash import poseidon as pos
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    from plonky2_tpu_torch.field.convert import from_u64
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.ops import ntt_cuda as nc
    from plonky2_tpu_torch.plonk import constraint_program as cp
    from plonky2_tpu_torch.plonk import constraint_program_cuda as cpc
    import torch
    rng = np.random.default_rng(SEED + 1)
    res = {}

    def compare(entry, what, kernel_fn, plain_fn, timed=False):
        k_ms, got = cuda_ms(kernel_fn)
        # the plain version's time after a warm-up call where it is kept
        p_ms, want = cuda_ms(plain_fn, warmup=timed)
        err = max_abs_err(flat(got), flat(want))
        log(f"  {kernel_label(entry)} {what}: max_abs_err {err} "
            f"(kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms)")
        check(err == 0, f"{entry} {what} differs from its plain version")
        r = res.setdefault(entry, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if timed:
            r.update(kernel_ms_at_plain_shape=k_ms, plain_ms=p_ms,
                     plain_shape=what)

    # the commitments' widths, the FRI layers' 2 x 16, and boundary values;
    # the keccak table's width at its LDE in the block proof (2^12 rows,
    # rate 1)
    for L, log_n, make in ((234, 14, rand_field), (135, 14, rand_field),
                           (2481, 13, rand_field), (32, 14, rand_field),
                           (234, 14, boundary_field),
                           (135, 14, boundary_field),
                           (9, 14, boundary_field)):
        leaves = make(rng, (L, 1 << log_n), dev)
        kind = " boundary" if make is boundary_field else ""
        compare("plk_hash_leaves", f"L={L} N=2^{log_n}{kind}",
                lambda: pc.hash_leaves_cols_cuda(leaves),
                lambda: pos.hash_leaves_cols(leaves),
                timed=L == 234 and not kind)
    for label, level in (("m=2^14 digests", rand_field(rng, (4, 1 << 15), dev)),
                         ("m=2^14 boundary", boundary_field(rng, (4, 1 << 15), dev))):
        compare("plk_compress_level", label,
                lambda: pc.compress_level_cuda(level),
                lambda: pc.compress_level(level), timed="digests" in label)
    # K2's narrow top: a 2^21-leaf tree's 11 levels from 2^14 parents to the
    # cap of 16, the same to one root, a 2^5-leaf tree from its digests
    # (FRI layer 3), and 2^16 parents (more nodes than the grid holds)
    digests32 = pc.hash_leaves_cols_cuda(rand_field(rng, (32, 32), dev))
    for label, level, n_levels in (
            ("m0=2^14, 11 levels to cap 4", rand_field(rng, (4, 1 << 15), dev),
             11),
            ("m0=2^14 boundary, 15 levels to cap 0",
             boundary_field(rng, (4, 1 << 15), dev), 15),
            ("2^5 leaf digests, 5 levels to cap 0", digests32, 5),
            ("2^5 leaf digests, 1 level to cap 4", digests32, 1),
            ("2^5 boundary digests, 3 levels to cap 2",
             boundary_field(rng, (4, 32), dev), 3),
            ("m0=2^16, 13 levels to cap 4", rand_field(rng, (4, 1 << 17), dev),
             13)):
        compare("plk_compress_tail", label,
                lambda: pc.compress_tail_cuda(level, n_levels),
                lambda: pc.compress_tail(level, n_levels),
                timed=label.startswith("m0=2^14, 11"))
    # the column forms at the main paths' n1 (512 for the IFFT, 1024 for
    # the LDE and the 2^21-point INTT) and a small one
    for n1, n2 in ((512, 512), (1024, 2048), (2048, 512), (16, 8)):
        a = rand_field(rng, (4, n1, n2), dev)
        a[0] = boundary_field(rng, (n1, n2), dev)
        pre = rand_field(rng, (n1, n2), dev)
        post = rand_field(rng, (n1, n2), dev)
        for inverse in (False, True):
            compare("plk_ntt_cols_dit",
                    f"B=4 n1={n1} n2={n2} inverse={inverse}",
                    lambda: nc.ntt_cols_cuda(a, inverse),
                    lambda: nc.ntt_cols(a, inverse),
                    timed=n1 == 512 and not inverse)
        compare("plk_ntt_cols_dit", f"B=4 n1={n1} n2={n2} pre+post",
                lambda: nc.ntt_cols_cuda(a, True, pre, post),
                lambda: nc.ntt_cols(a, True, pre, post))
    # K5 with the LDE's tail of 896 rows at the main path's n2, without a
    # tail, with a ragged prefix (q not a power of two) and a small n2
    # and the FRI folds' evaluations without a tail (2^17 and 2^5 points)
    for q, tail, n2 in ((128, 896, 2048), (128, 896, 512), (1024, 0, 512),
                        (2048, 0, 64), (100, 924, 64), (3, 13, 8),
                        (256, 0, 512), (4, 0, 8)):
        n1 = q + tail
        a = rand_field(rng, (4, q, n2), dev)
        a[0] = boundary_field(rng, (q, n2), dev)
        pre = rand_field(rng, (q, n2), dev)
        post = rand_field(rng, (n1, n2), dev)
        what = f"B=4 n1={n1} tail={tail} n2={n2}"
        compare("plk_ntt_cols_dif", what,
                lambda: nc.ntt_cols_dif_cuda(a, tail),
                lambda: nc.ntt_cols_dif(a, tail),
                timed=(q, tail, n2) == (128, 896, 512))
        compare("plk_ntt_cols_dif", what + " pre+post",
                lambda: nc.ntt_cols_dif_cuda(a, tail, pre=pre, post=post),
                lambda: nc.ntt_cols_dif(a, tail, pre=pre, post=post))
    for q, r, n2, boundary in ((128, 3, 2048, False), (128, 3, 512, False),
                               (128, 3, 512, True), (1, 3, 512, False),
                               (1024, 1, 64, False), (512, 0, 64, False),
                               (2, 2, 8, True)):
        make = boundary_field if boundary else rand_field
        a = make(rng, (4, q, n2), dev)
        pre = rand_field(rng, (q, n2), dev)
        post = rand_field(rng, (q << r, n2), dev)
        what = f"B=4 q={q} r={r} n2={n2}" + (" boundary" if boundary else "")
        compare("plk_ntt_cols_zero_tail", what,
                lambda: nc.ntt_cols_zero_tail_cuda(a, r),
                lambda: nc.ntt_cols_zero_tail(a, r),
                timed=(q, n2) == (128, 512) and not boundary)
        compare("plk_ntt_cols_zero_tail", what + " pre+post",
                lambda: nc.ntt_cols_zero_tail_cuda(a, r, pre=pre, post=post),
                lambda: nc.ntt_cols_zero_tail(a, r, pre=pre, post=post))
    # the row forms at the main paths' shapes (IFFT pass 2: n1 = n2 = 512;
    # LDE and INTT pass 2: n1 = 1024, n2 = 2048) and small, ragged ones;
    # K5's runs in place on a copy of the input
    for B, n1, n2 in ((4, 512, 512), (4, 1024, 2048), (3, 2048, 1024),
                      (2, 256, 512), (2, 4, 8), (2, 16, 8), (3, 2, 64),
                      (2, 1, 8)):
        a = rand_field(rng, (B, n1, n2), dev)
        a[0] = boundary_field(rng, (n1, n2), dev)
        post = rand_field(rng, (n2, n1), dev)
        what = f"B={B} n1={n1} n2={n2}"
        for inverse in (False, True):
            compare("plk_ntt_rows_dit", what + f" inverse={inverse}",
                    lambda: nc.ntt_rows_cuda(a, inverse),
                    lambda: nc.ntt_rows(a, inverse),
                    timed=(n1, n2) == (512, 512) and not inverse)
        compare("plk_ntt_rows_dit", what + " post",
                lambda: nc.ntt_rows_cuda(a, True, post),
                lambda: nc.ntt_rows(a, True, post))

        def in_place():
            x = a.clone()
            check(nc.ntt_rows_dif_cuda(x) is x, "the row DIF returned "
                  "another tensor")
            return x
        compare("plk_ntt_rows_dif", what + " in place", in_place,
                lambda: nc.ntt_rows_dif(a), timed=(n1, n2) == (1024, 2048))

    prog, _ = flagship_program()
    draw = lambda k: [int(x) for x in rng.integers(  # noqa: E731
        0, P, size=k, dtype=np.uint64)]
    bank = from_u64(prog.scalar_bank(draw(prog.n_scalar_inputs)), dev)
    for label, make in (("random", rand_field), ("boundary", boundary_field)):
        inputs = make(rng, (prog.n_inputs, CHECK_LANES), dev)
        compare("plk_constraint_program",
                f"flagship program, {CHECK_LANES} lanes, {label} inputs",
                lambda: cpc.run_program_cuda(prog, inputs, bank),
                lambda: prog.run_plain(inputs, bank),
                timed=label == "random")
    res["k6_programs"] = k6_programs(dev, rng, compare)
    for W in (8, 16, 32):
        small = cp.random_program(rng, wave_width=W, n_regs=3 * W)
        check(cp.in_wave_reuse(small), "random program reuses no register")
        inputs = rand_field(rng, (small.n_inputs, 1000), dev)
        sbank = from_u64(small.scalar_bank(draw(2)), dev)
        compare("plk_constraint_program",
                f"random program W={W}, in-wave register reuse",
                lambda: cpc.run_program_cuda(small, inputs, sbank),
                lambda: small.run_plain(inputs, sbank))
    # K7 writes its waves into a slot buffer in place; a second run writes
    # the same values (no wave writes a slot that it or a wave before it
    # reads), so the warm-up call leaves the result unchanged.  Chains of
    # waves that read the wave before them (the flagship's run from 2^16
    # rows down to 1, cut to five waves, and eight small ones), one wave
    # of 2^16 rows, waves of 2^14 rows with every swap wire 0 or 1, swap
    # wires mixed elsewhere, and 2 in one row of the last wave.
    from plonky2_tpu_torch.hash import poseidon_wires as pw
    for sizes, swap, bad in (((1 << 14, 1 << 10, 1 << 6, 2, 1), None, False),
                             ((1 << 14, 1 << 10, 1 << 6, 2, 1), None, True),
                             ((1 << 16,), None, False),
                             ((1 << 14,), 0, False), ((1 << 14,), 1, False),
                             ((33, 17, 9, 5, 3, 2, 1, 1), None, True),
                             ((1,), 1, False)):
        values, dep, out, offsets = wave_chain(rng, sizes, dev, swap)
        if bad:
            values[dep[12, offsets[-1] - 1]] = 2
        kv, pv = values.clone(), values.clone()
        ek, ep = (torch.zeros(1, dtype=torch.int32, device=dev)
                  for _ in range(2))
        compare("plk_poseidon_wires_waves",
                f"waves {list(sizes)} swap="
                f"{'mixed' if swap is None else swap}"
                + (", 2 in the last wave" if bad else "")
                + ", boundary inputs",
                lambda: (pc.poseidon_wires_waves_cuda(kv, dep, out, offsets,
                                                      ek), kv)[1],
                lambda: (pw.poseidon_wires_waves(pv, dep, out, offsets, ep),
                         pv)[1],
                timed=sizes == (1 << 14, 1 << 10, 1 << 6, 2, 1) and not bad)
        check(bool(ek.item()) == bool(ep.item()) == bad,
              "K7's swap flag differs from its plain version's")
    # K8 at 0-20 bits (the witness position and the base state vary with
    # the bits), at every position at 2 and 12 bits, from offsets, and at
    # 1-4 bits, where many candidates of one chunk pass
    cases = [(bits, bits % 8, 0) for bits in range(21)]
    cases += [(bits, word, 0) for bits in (2, 12) for word in range(8)]
    cases += [(bits, 5, start) for bits in (1, 4, 16)
              for start in (1, 127, 128, 1000)]
    for bits, word, start in cases:
        base = rand_field(rng, (12,), dev)
        base[bits % 12] = boundary_field(rng, (1,), dev)[0]
        got = [None]

        def kernel():
            got[0] = pc.pow_grind_cuda(base, word, bits, start)
            return torch.tensor([got[0]])

        def plain():
            return torch.tensor([pc.pow_grind(base, word, bits, start,
                                              batch=1 << 16)])
        compare("plk_pow_grind", f"{bits} bits, word {word}, start {start}",
                kernel, plain, timed=(bits, word, start) == (16, 0, 0))
    # K8 on the transcript's sponge (the fused FRI's form): the duplex
    # input state from K9's buffer at every pending count, 0-20 bits; the
    # witness written into the pending slot, the rest of the buffer kept
    for bits, n_in in ((0, 0), (1, 1), (2, 2), (4, 3), (8, 4), (12, 5),
                       (16, 6), (20, 7), (16, 0)):
        buf = rand_field(rng, (pc.SPONGE_WORDS,), dev)
        buf[(bits + 5) % 12] = boundary_field(rng, (1,), dev)[0]

        def kernel():
            b = buf.clone()
            return torch.cat([pc.pow_grind_sponge_cuda(b, n_in, bits), b])

        def plain():
            b = buf.clone()
            b[pos.WIDTH + n_in] = pc.pow_grind(pc.duplex_input(buf, n_in),
                                               n_in, bits, batch=1 << 16)
            return torch.cat([b[pos.WIDTH + n_in:pos.WIDTH + n_in + 1], b])
        compare("plk_pow_grind", f"on the sponge, {bits} bits, {n_in} "
                "pending", kernel, plain)
        if (bits, n_in) == (16, 0):
            res["grind_record"] = grind_record(dev)
    # K9 on random buffers: a FRI layer's launch (a 16-digest cap, beta
    # and its 16 powers), the final polynomial's (4 of 32 coefficients in
    # rows of 32), the launch after the grind (the witness pending, then
    # the response and 28 query indices), and every pending count with
    # words on and off the rate boundary, refills and a full buffer
    cases = [("FRI layer: cap of 16 digests, beta and 16 powers", 3, 0,
              rand_field(rng, (4, 16), dev), 2, 0, 16),
             ("final polynomial: 4 coefficients", 2, 0,
              rand_field(rng, (2, 32), dev)[:, :4], 0, 0, 0),
             ("after the grind: response and 28 indices", 8, 0, None, 29,
              (1 << 21) - 1, 0)]
    for n_in in (0, 1, 5, 7, 8):
        cases.append((f"{n_in} pending, 13 words, 11 draws", n_in,
                      int(rng.integers(0, 9)), rand_field(rng, (1, 13), dev),
                      11, 0, 0))
        cases.append((f"{n_in} pending, no words, 17 draws, 4 powers", n_in,
                      int(rng.integers(0, 9)), None, 17, 1023, 4))
    for what, n_in, n_out, src, n_draws, mask, arity in cases:
        buf = rand_field(rng, (pc.SPONGE_WORDS,), dev)

        def run(fn):
            b = buf.clone()
            out = fn(b, n_in, n_out, src, n_draws, mask, arity)
            return torch.cat([o.reshape(-1) for o in out if o is not None]
                             + [b])
        compare("plk_sponge", what, lambda: run(pc.sponge_cuda),
                lambda: run(pc.sponge), timed=what.startswith("FRI layer"))
    return res


def gate_mix_program():
    """The gate mix's quotient program (models/gate_mix.py; the program
    depends on the gates and the config, not on the copies)."""
    from plonky2_tpu_torch.models.gate_mix import build_gate_mix_circuit
    from plonky2_tpu_torch.plonk.quotient_program import \
        build_quotient_program
    data, _, _ = build_gate_mix_circuit(copies=1, device="cpu")
    return build_quotient_program(data.common)


def keccak_table_program():
    """The keccak table's quotient program (evm/keccak_stark.py's eval,
    then its checks of the one CTL it is looked up by) under
    standard_fast_config, compiled apart from phase 9e's."""
    from plonky2_tpu_torch.evm import all_stark
    from plonky2_tpu_torch.evm.cross_table_lookup import ctl_zs_layout
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.quotient_program import build_stark_program
    config = StarkConfig.standard_fast_config()
    return build_stark_program(
        all_stark.KeccakStark(), config,
        ctl_zs_layout(all_stark.all_cross_table_lookups(), all_stark.KECCAK,
                      config.num_challenges))


def system_zero_program():
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.quotient_program import stark_program
    from plonky2_tpu_torch.system_zero.system_zero import SystemZero
    return stark_program(SystemZero(), StarkConfig.standard_fast_config())


@functools.lru_cache(maxsize=1)
def recursion_circuits() -> dict:
    """The recursion chain's first two circuits under
    standard_recursion_config, built by the port on the card (the
    constants-sigmas commitments there): the no-op circuit of
    2^RECURSION_INNER_LOG rows and the circuit that verifies its proofs,
    which needs only the first one's common data; each with its build
    seconds.  Phase 3 runs K6 on the second one's program, phase 9h
    proves both."""
    import torch
    from plonky2_tpu_torch.models import bench_recursion as br
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    config = CircuitConfig.standard_recursion_config()
    t = time.perf_counter()
    dummy = br.dummy_circuit_of_size(config, RECURSION_INNER_LOG)
    torch.cuda.synchronize()
    dummy_s = time.perf_counter() - t
    timer = StageTimer()
    t = time.perf_counter()
    single, pt, vt = br.recursion_circuit(dummy.common, config,
                                          timing=timer)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t
    log(f"  recursion circuits built on the card: the no-op circuit "
        f"(2^{dummy.common.degree_bits()} rows) in {dummy_s:.3f} s, the "
        f"circuit verifying its proofs (2^{single.common.degree_bits()} "
        f"rows) in {single_s:.3f} s")
    return {"config": config, "dummy": dummy, "dummy_s": dummy_s,
            "single": (single, pt, vt), "single_s": single_s,
            "single_stages_ms": timer.ms}


def single_recursion_program():
    from plonky2_tpu_torch.plonk.quotient_program import \
        build_quotient_program
    return build_quotient_program(recursion_circuits()["single"][0].common)


def k6_programs(dev, rng, compare) -> dict:
    """K6 on twelve programs, each held against run_plain (exact) and
    timed at K6_TIMING_LANES lanes (CUDA events, the median of 3 launches
    after a warm-up): the flagship's, the gate mix's, a program of more
    slots than shared memory holds at 32 lanes a block
    (constraint_program.py:wide_program), the EVM keccak table's (about
    29,000 ops), System Zero's, the single-recursion circuit's, the
    Fibonacci and EVM wrappers' (phase 9i), the U32 and permutation gate
    set's (9k), the ECDSA circuit's (9l), the range-checked arithmetic
    table's (9m) and the block's CPU table's with its CTL checks (9n).
    Per
    program its form (lanes a block, slots in shared memory and spilled),
    ms a launch and ns a lane."""
    from plonky2_tpu_torch.field.convert import from_u64
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.plonk import constraint_program as cp
    from plonky2_tpu_torch.plonk import constraint_program_cuda as cpc
    progs = {"flagship": flagship_program()[0],
             "gate mix": gate_mix_program(),
             "wide": cp.wide_program(),
             "keccak table": keccak_table_program(),
             "system zero": system_zero_program(),
             "single recursion": single_recursion_program(),
             **wrapper_programs(),
             "gate set": gate_set_program(),
             "ECDSA circuit": ecdsa_program(),
             "arithmetic table": arithmetic_program(),
             "CPU table": cpu_table_program()}
    out = {}
    for name, prog in progs.items():
        lin = cp.linearize(prog)
        form = cpc.k6_form(lin.n_slots, max(1, len(prog.bank_sids)))
        bank = from_u64(prog.scalar_bank([int(x) for x in rng.integers(
            0, P, size=prog.n_scalar_inputs, dtype=np.uint64)]), dev)
        what = (f"{name} program ({lin.n_ops} ops, {lin.n_slots} slots: "
                f"{form.lanes} lanes a block, {form.n_shared} in shared "
                f"memory, {form.n_spilled} spilled)")
        if name != "flagship":          # the flagship's is checked above
            for label, make in (("random", rand_field),
                                ("boundary", boundary_field)):
                inputs = make(rng, (prog.n_inputs, CHECK_LANES + 37), dev)
                compare("plk_constraint_program",
                        f"{what}, {CHECK_LANES + 37} lanes, {label} inputs",
                        lambda: cpc.run_program_cuda(prog, inputs, bank),
                        lambda: prog.run_plain(inputs, bank))
        rows = rand_field(rng, (lin.n_read, K6_TIMING_LANES), dev)
        cpc.run_program_cuda(prog, rows, bank)
        ms = sorted(cuda_ms(lambda: cpc.run_program_cuda(prog, rows, bank),
                            warmup=False)[0] for _ in range(3))[1]
        out[name] = {"n_ops": lin.n_ops, "n_slots": lin.n_slots,
                     "bank": len(prog.bank_sids), "lanes": form.lanes,
                     "n_shared": form.n_shared, "n_spilled": form.n_spilled,
                     "blocks_per_sm": form.blocks_per_sm(),
                     "lanes_timed": K6_TIMING_LANES, "ms": ms,
                     "ns_per_lane": ms * 1e6 / K6_TIMING_LANES}
        log(f"  K6 form and time: {what}: {ms:.3f} ms for "
            f"{K6_TIMING_LANES} lanes, {out[name]['ns_per_lane']:.2f} ns "
            "a lane")
    check(out["wide"]["n_slots"] >= 1200 and out["wide"]["n_spilled"] > 0,
          "the wide program does not spill K6's shared memory")
    return out


def grind_record(dev) -> dict:
    """K8's record of its last launch (hash/poseidon_cuda.py:grind_scratch):
    its span on the card's clock, its rounds and its answer."""
    from plonky2_tpu_torch.field.convert import to_u64
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    r = [int(x) for x in to_u64(pc.grind_scratch(dev))]
    out = {"span_ms": (r[2] - r[1]) / 1e6, "rounds": r[3], "witness": r[4]}
    log(f"  K8's last launch: {out['rounds']} rounds of the resident grid, "
        f"{out['span_ms']:.4f} ms from block 0's entry to its exit "
        f"(witness {out['witness']})")
    return out


def wave_chain(rng, sizes, dev, swap=None, rows=False):
    """A slot buffer holding a chain of Poseidon waves of `sizes` rows:
    (values, dep_idx (13, R), out_idx (122, R), offsets).  Row i of wave
    j > 0 reads its words 0-3 from the outputs 0-3 of wave j - 1's row 2i
    and its words 4-7 from row 2i + 1's (mod that wave's size), as a Merkle
    level reads the one below, so each wave reads what other blocks wrote;
    words 8-11 and the swap wire lie in slots of their own (odd rows
    boundary values; swap wires `swap`, or 0 and 1 at random when None).
    The slots lie at random (rows=False), or as the witness plan lays a
    gate's wires: row r's wire c at slot r * 234 + c, in the Poseidon
    gate's columns (rows=True, the flagship's 234 wires)."""
    import torch
    from plonky2_tpu_torch.field.convert import from_u64
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.gates import poseidon_gate as pg
    R = sum(sizes)
    if rows:
        n_slots = NUM_WIRES * R
        base = np.arange(R, dtype=np.int64)[None] * NUM_WIRES
        dep = (base + pg.DEP_WIRES[:, None]).astype(np.int32)
        out = (base + pg.OUTPUT_WIRES[:, None]).astype(np.int32)
    else:
        n_slots = 135 * R + 7
        slots = rng.permutation(n_slots)[:135 * R].astype(np.int32)
        dep = slots[:13 * R].reshape(13, R).copy()
        out = slots[13 * R:].reshape(122, R)
    buf = rng.integers(0, P, size=n_slots, dtype=np.uint64)
    buf[dep[:12, 1::2]] = np.array(BOUNDARY, dtype=np.uint64)[
        rng.integers(0, len(BOUNDARY), size=(12, R // 2))]
    buf[dep[12]] = rng.integers(0, 2, size=R) if swap is None else swap
    offsets = tuple(int(x) for x in np.cumsum((0,) + tuple(sizes)))
    for j in range(1, len(sizes)):
        a0, a, g0 = offsets[j - 1], offsets[j], sizes[j - 1]
        i = np.arange(sizes[j])
        dep[0:4, a:a + sizes[j]] = out[110:114, a0 + (2 * i) % g0]
        dep[4:8, a:a + sizes[j]] = out[110:114, a0 + (2 * i + 1) % g0]
    return (from_u64(buf, dev), torch.from_numpy(dep).to(dev),
            torch.from_numpy(out).to(dev), offsets)


def phase_narrow_levels(dev) -> dict:
    """K2 on the narrow top of a 2^21-leaf tree (cap 4: the 11 levels of
    2^14 down to 16 parents), old path against new in one call.  The
    steps are timed with CUDA events between consecutive steps, either
    queued behind K1 on the flagship's (234, 2^18) leaves, so that the host
    has queued them all before the card reaches them and the events read
    device time only, or host-paced, on an idle card, as a path without a
    long kernel ahead meets them.  Also 64 launches at 32 parents behind
    K1 (per launch: one permutation's latency in one warp and a launch
    gap), and the threshold: the 13 levels above a (4, 2^17) level with
    the levels of more than T parents one launch each and the rest one
    narrow top, for T = 2^13 .. 2^16.  Medians of NARROW_REPS runs."""
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    rng = np.random.default_rng(SEED + 4)
    leaves = rand_field(rng, (NUM_POLYS, 1 << LOG_N), dev)
    wide = rand_field(rng, (4, 1 << 17), dev)
    top = pc.compress_level_cuda(pc.compress_level_cuda(wide))   # (4, 2^15)
    small = rand_field(rng, (4, 64), dev)

    def timed_steps(make_steps, behind):
        return timed_step_ms(make_steps, leaves if behind else None)

    def levels(x, n_wide, n_tail):
        """(steps, cur): n_wide per-level launches, then one narrow top;
        cur collects x and the levels."""
        cur = [x]
        steps = [lambda: cur.append(pc.compress_level_cuda(cur[-1]))] * n_wide
        if n_tail:
            steps.append(lambda: cur.extend(pc.compress_tail_cuda(cur[-1],
                                                                  n_tail)))
        return steps, cur

    res = {}
    for mode, behind in (("device", True), ("host-paced", False)):
        old = timed_steps(lambda: levels(top, NARROW_LEVELS, 0)[0], behind)
        new = timed_steps(lambda: levels(top, 0, NARROW_LEVELS)[0], behind)
        res[mode] = {"per_level_ms": old, "per_level_sum_ms": sum(old),
                     "tail_ms": new[0]}
        log(f"  {mode}: the 11 narrow levels one launch each: "
            f"{', '.join(f'{x:.4f}' for x in old)} ms (sum {sum(old):.4f}); "
            f"in one narrow-top launch: {new[0]:.4f} ms")
    m32 = timed_steps(lambda: [lambda: pc.compress_level_cuda(small)] * 64,
                      True)
    res["m32_launch_ms"] = sum(m32) / 64
    log(f"  64 launches of 32 parents behind K1: {sum(m32):.4f} ms, "
        f"{res['m32_launch_ms']:.4f} ms a launch")
    res["threshold"] = {}
    for log_t in (13, 14, 15, 16):
        n_tail = log_t - CAP_HEIGHT + 1
        row = {}
        for mode, behind in (("device", True), ("host-paced", False)):
            row[mode] = sum(timed_steps(
                lambda: levels(wide, 13 - n_tail, n_tail)[0], behind))
        res["threshold"][f"2^{log_t}"] = row
        log(f"  T = 2^{log_t}: {13 - n_tail} per-level launch(es) + a narrow "
            f"top of {n_tail} levels above (4, 2^17): device "
            f"{row['device']:.4f} ms, host-paced {row['host-paced']:.4f} ms")
    steps, want = levels(top, NARROW_LEVELS, 0)
    for fn in steps:
        fn()
    got = pc.compress_tail_cuda(top, NARROW_LEVELS)
    check(max_abs_err(flat(got), flat(want[1:])) == 0,
          "the narrow top differs from the per-level launches")
    log("  the narrow top equals the 11 per-level launches word for word")
    return res


def _event():
    import torch
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def timed_step_ms(make_steps, leaves=None) -> list:
    """Median over NARROW_REPS of each step's ms, between CUDA events
    recorded between consecutive steps: queued behind K1 on `leaves`, so
    that the host has queued every step before the card reaches them and
    the events read device time only, or, with no leaves, host-paced on
    an idle card.  `make_steps()` gives a fresh list of steps each time."""
    import torch
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    runs = []
    for _ in range(NARROW_REPS):
        steps = make_steps()
        torch.cuda.synchronize()
        if leaves is not None:
            k0 = _event()
            pc.hash_leaves_cols_cuda(leaves)
        evs = [_event()]
        t = time.perf_counter()
        for fn in steps:
            fn()
            evs.append(_event())
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        if leaves is not None:
            k1_ms = k0.elapsed_time(evs[0])
            check(host_ms < k1_ms, f"the host took {host_ms:.3f} ms to "
                  f"queue the steps, K1 ran {k1_ms:.3f} ms")
        runs.append([a.elapsed_time(b) for a, b in zip(evs, evs[1:])])
    return [float(np.median(col)) for col in zip(*runs)]


def phase_witness_waves(dev) -> dict:
    """K7 on the flagship plan's 18 Poseidon wave sizes (FLAGSHIP_WAVES,
    2^16 rows down to 1, then 1), as a chain in which each wave reads the
    one before, its wires laid out in rows as the plan lays them: each
    wave as a launch of its own and all 18 in one launch, device time
    (queued behind K1 on the flagship's leaves) and host-paced (medians
    of NARROW_REPS runs; K7 writes the same values each run).
    One permutation's latency, split over four lanes, is the device time of
    a one-row wave alone: the latency floor of the 18 is 18 of them.  The
    one launch must write what the 18 launches write."""
    import torch
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    rng = np.random.default_rng(SEED + 5)
    leaves = rand_field(rng, (NUM_POLYS, 1 << LOG_N), dev)
    values, dep, out, offsets = wave_chain(rng, FLAGSHIP_WAVES, dev,
                                           rows=True)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    n = len(FLAGSHIP_WAVES)

    def run(lo, hi):
        return lambda: pc.poseidon_wires_waves_cuda(
            values, dep, out, offsets[lo:hi + 1], err)

    def each():
        return [run(j, j + 1) for j in range(n)]

    for fn in each() + [run(0, n)]:     # uploads each run's offsets once
        fn()
    torch.cuda.synchronize()
    res = {"sizes": list(FLAGSHIP_WAVES)}
    for mode, behind in (("device", leaves), ("host-paced", None)):
        per_wave = timed_step_ms(each, behind)
        fused = timed_step_ms(lambda: [run(0, n)], behind)[0]
        res[mode] = {"per_wave_ms": per_wave, "per_wave_sum_ms": sum(per_wave),
                     "one_launch_ms": fused}
        log(f"  {mode}: the {n} waves one launch each (rows: ms): "
            + ", ".join(f"{g}: {ms:.4f}"
                        for g, ms in zip(FLAGSHIP_WAVES, per_wave))
            + f" (sum {sum(per_wave):.4f}); all {n} in one launch: "
            f"{fused:.4f} ms")
    ones = [ms for g, ms in zip(FLAGSHIP_WAVES, res["device"]["per_wave_ms"])
            if g == 1]
    res["perm_latency_ms"] = float(np.median(ones))
    res["latency_floor_ms"] = n * res["perm_latency_ms"]
    log(f"  one permutation over 4 lanes (a one-row wave, device time): "
        f"{res['perm_latency_ms']:.4f} ms; the {n} waves' latency floor "
        f"{res['latency_floor_ms']:.4f} ms")
    e1 = torch.zeros_like(err)
    one = values.clone()
    pc.poseidon_wires_waves_cuda(one, dep, out, offsets, e1)
    per = values.clone()
    for j in range(n):
        pc.poseidon_wires_waves_cuda(per, dep, out, offsets[j:j + 2], e1)
    check(max_abs_err(one, per) == 0 and not e1.item(),
          "one launch of the 18 waves differs from 18 launches")
    log(f"  one launch writes what the {n} launches write, word for word")
    return res


def wrappers() -> dict:
    """C entry -> the wrappers that launch it (each counts its launches)."""
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    from plonky2_tpu_torch.ops import ntt_cuda as nc
    from plonky2_tpu_torch.plonk import constraint_program_cuda as cpc
    return {"plk_hash_leaves": (pc.hash_leaves_cols_cuda,),
            "plk_compress_level": (pc.compress_level_cuda,),
            "plk_compress_tail": (pc.compress_tail_cuda,),
            "plk_ntt_cols_dit": (nc.ntt_cols_cuda,),
            "plk_ntt_rows_dit": (nc.ntt_rows_cuda,),
            "plk_ntt_cols_zero_tail": (nc.ntt_cols_zero_tail_cuda,),
            "plk_ntt_cols_dif": (nc.ntt_cols_dif_cuda,),
            "plk_ntt_rows_dif": (nc.ntt_rows_dif_cuda,),
            "plk_constraint_program": (cpc.run_program_cuda,),
            "plk_poseidon_wires_waves": (pc.poseidon_wires_waves_cuda,),
            # on the transcript's sponge (fused FRI) and from host words
            # (layered FRI)
            "plk_pow_grind": (pc.pow_grind_sponge_cuda, pc.pow_grind_cuda),
            "plk_sponge": (pc.sponge_cuda,)}


def reset_launch_counts():
    for ws in wrappers().values():
        for w in ws:
            w.launches = 0


def read_launch_counts() -> dict:
    return {entry: sum(w.launches for w in ws)
            for entry, ws in wrappers().items()}


@contextlib.contextmanager
def per_level_merkle():
    """Every Merkle level on its own launch of K2's per-level form, as
    before the narrow top had a kernel of its own: the before side of K2's
    before and after."""
    from plonky2_tpu_torch.hash import merkle_torch
    saved = merkle_torch.TAIL_PARENTS
    merkle_torch.TAIL_PARENTS = 0
    try:
        yield
    finally:
        merkle_torch.TAIL_PARENTS = saved


def timed_path(run, path, label, keep=lambda out: None):
    """One cold run of a main path with the launch counts set to 0 just
    before and read just after, then WARM_RUNS warm runs timed per kernel,
    each after one warm run with every Merkle level on K2's per-level form
    (K2 before and after in turns).  `run(kept)` gets what `keep` takes
    from the previous run's result (None at first); the rest of that
    result is freed first.  The result returned is the last run's."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launch_counts()
    t = time.perf_counter()
    out = run(None)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  {label} cold run {cold_s:.3f} s; launches {launches}; peak "
        f"max_memory_allocated {peak / 2**30:.3f} GiB ({resident / 2**30:.3f}"
        " GiB of it held by earlier phases)")
    for entry in path:
        check(launches[entry] > 0, f"{entry} was not launched on the {label}")
    warm_s, per_kernel, recs, before = [], [], None, []
    for _ in range(WARM_RUNS):
        kept = keep(out)
        del out
        with per_level_merkle(), KernelRecorder() as rec:
            t = time.perf_counter()
            out = run(kept)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        k2 = [s.elapsed_time(e) for n, _, s, e in rec.records
              if n.startswith("plk_compress")]
        before.append((wall, sum(k2), len(k2)))
        kept = keep(out)
        del out
        with KernelRecorder() as rec:
            t = time.perf_counter()
            out = run(kept)
            torch.cuda.synchronize()
            warm_s.append(time.perf_counter() - t)
        per_kernel.append(rec.ms_by_kernel())
        recs = rec.records
    log(f"  {label} warm runs (s): {', '.join(f'{s:.4f}' for s in warm_s)}"
        f" (median {np.median(warm_s):.4f}; cold {cold_s:.3f})")
    k2_after = [sum(r[k] for k in r if k.startswith("plk_compress"))
                for r in per_kernel]
    k2_before = {"warm_s": [b[0] for b in before],
                 "k2_ms": [b[1] for b in before], "launches": before[0][2]}
    n_after = launches["plk_compress_level"] + launches["plk_compress_tail"]
    log(f"  {label} K2 before (every level its own launch, {before[0][2]} "
        f"launches): {', '.join(f'{b[1]:.3f}' for b in before)} ms, warm "
        f"runs {', '.join(f'{b[0]:.4f}' for b in before)} s; after "
        f"({n_after} launches): {', '.join(f'{x:.3f}' for x in k2_after)} ms")
    kernel_ms = {k: float(np.median([r[k] for r in per_kernel]))
                 for k in per_kernel[0]}
    for k, ms in kernel_ms.items():
        log(f"  {kernel_label(k)}: {ms:.3f} ms over {launches[k]} launches "
            f"(median of warm runs; {100 * ms / 1e3 / np.median(warm_s):.1f}% "
            "of the warm wall)")
    cost = path_cost(recs, pow_witness_of(out))
    last_run = [(name, args, s.elapsed_time(e)) for name, args, s, e in recs]
    return out, {"cold_s": cold_s, "warm_s": warm_s, "launches": launches,
                 "kernel_ms": kernel_ms, "cost": cost, "peak_bytes": peak,
                 "resident_bytes": resident, "k2_before": k2_before,
                 "last_run": last_run}


def pow_witness_of(result):
    """The proof-of-work witness of a path's result (an opening round's
    (openings, FriProof), a proof), or None where it has none."""
    if hasattr(result, "stark_proofs"):         # a multi-table proof
        return [p.opening_proof.pow_witness for p in result.stark_proofs]
    for obj in result if isinstance(result, tuple) else (result,):
        while obj is not None:
            if hasattr(obj, "pow_witness"):
                return obj.pow_witness
            obj = getattr(obj, "proof", getattr(obj, "opening_proof", None))
    return None


def path_cost(records, pow_witness=None) -> dict:
    """C entry -> [bytes, int32 multiplies, float64 multiply-adds] summed
    over the launches recorded in one run.  `pow_witness` is a list where
    the run grinds more than once (one for each K8 launch, in order)."""
    cost = {}
    witnesses = iter(pow_witness if isinstance(pow_witness, list) else ())
    for name, args, _, _ in records:
        c = cost.setdefault(name, [0, 0, 0])
        w = pow_witness
        if isinstance(pow_witness, list):
            w = next(witnesses) if name == "plk_pow_grind" else None
        for j, x in enumerate(launch_cost(name, args, w)):
            c[j] += x
    return cost


def log_merkle_levels(res) -> dict:
    """K2 launch by launch in the last warm run, beside the time its
    permutations would take at the rate K1 reached in the same run (K1 and
    K2 share the permutation): what is left is K2's own, the launches and
    the levels too small to fill the card.  A narrow top (one launch)
    shows its levels' parents together."""
    from plonky2_tpu_torch.kernels import named_args
    k1_perms = sum(launch_cost(n, a)[1] for n, a, _ in res["last_run"]
                   if n == "plk_hash_leaves") / PERM_MULS
    k1_ms = sum(ms for n, _, ms in res["last_run"] if n == "plk_hash_leaves")
    ns_per_perm = k1_ms * 1e6 / k1_perms
    levels, tails = [], []
    for n, a, ms in res["last_run"]:
        a = named_args(n, a) if n.startswith("plk_compress") else None
        if n == "plk_compress_level":
            levels.append([a["m"], ms])
            log(f"  K2 level of {a['m']} parents: {ms:.4f} ms (its "
                f"permutations at K1's rate: "
                f"{a['m'] * ns_per_perm / 1e6:.4f} ms)")
        elif n == "plk_compress_tail":
            m0, k = a["m0"], a["n_levels"]
            parents = tail_parents(m0, k)
            tails.append([m0, k, parents, ms])
            log(f"  K2 narrow top, {k} levels of {m0} down to "
                f"{m0 >> (k - 1)} parents ({parents} permutations) in one "
                f"launch: {ms:.4f} ms (its permutations at K1's rate: "
                f"{parents * ns_per_perm / 1e6:.4f} ms)")
    total = sum(x[-1] for x in levels + tails)
    perm_ms = (sum(m for m, _ in levels) + sum(t[2] for t in tails)) \
        * ns_per_perm / 1e6
    log(f"  K2: {len(levels) + len(tails)} launches ({len(tails)} narrow "
        f"tops), {total:.3f} ms; permutations at K1's {ns_per_perm:.3f} ns "
        f"each: {perm_ms:.3f} ms; K2's own: {total - perm_ms:.3f} ms")
    return {"launches": len(levels) + len(tails), "ms": total,
            "perm_ms": perm_ms, "ns_per_perm": ns_per_perm,
            "levels": levels, "tails": tails}


def phase_full_width(dev, rng):
    """The commitment path at full width: one cold run (counted),
    WARM_RUNS warm runs (timed per kernel), then the result against the
    plain versions on subsets."""
    from plonky2_tpu_torch.fri.oracle import PolynomialBatch
    n = 1 << LOG_N
    values = rand_field(rng, (NUM_POLYS, n), dev)

    def run(_):
        return PolynomialBatch.from_values(values, RATE_BITS, False,
                                           CAP_HEIGHT, device=dev)

    batch, res = timed_path(run, COMMIT_PATH, "commit path")
    res["merkle_levels"] = log_merkle_levels(res)
    res["profile"] = profile_run(lambda: run(None))
    check_full_width(batch, values, rng)
    res.update(batch=batch, values=values)
    return res


def check_full_width(batch, values, rng):
    """Hold the full-width result against the plain versions on subsets."""
    import torch
    from plonky2_tpu_torch.field import fft
    from plonky2_tpu_torch.hash import poseidon as pos
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    from plonky2_tpu_torch.utils.bits import bit_reverse_indices
    n = values.shape[1]
    m = n << RATE_BITS
    dev = values.device
    leaves = batch.leaves_dev
    levels = batch.merkle_tree.levels_dev
    check(tuple(leaves.shape) == (NUM_POLYS, m), f"leaves {leaves.shape}")
    check(tuple(levels[-1].shape) == (4, 1 << CAP_HEIGHT), "cap shape")

    rows = torch.from_numpy(np.sort(rng.choice(NUM_POLYS, 8, replace=False)))
    rows = rows.to(dev)
    coeffs = fft.ifft(values[rows])
    check(max_abs_err(coeffs, batch.coeffs_dev[rows]) == 0,
          "coefficients differ from the plain IFFT")
    padded = torch.cat([coeffs, coeffs.new_zeros((8, m - n))], dim=1)
    perm = torch.from_numpy(bit_reverse_indices(m)).to(dev)
    lde = fft.coset_fft(padded)[:, perm]
    check(max_abs_err(lde, leaves[rows]) == 0,
          "leaf rows differ from the plain coset LDE")
    log(f"  8 polynomials {rows.tolist()}: plain IFFT and LDE equal")
    del padded, lde, coeffs

    cols = torch.from_numpy(np.sort(rng.choice(m, 4096, replace=False)))
    cols = cols.to(dev)
    dig = pos.hash_leaves_cols(leaves[:, cols])
    check(max_abs_err(dig, levels[0][:, cols]) == 0,
          "leaf digests differ from the plain sponge")
    log("  plain sponge on 4096 sampled leaf columns: equal")
    checked = 0
    for k in range(1, len(levels)):
        if levels[k].shape[1] <= 1 << 14:
            want = pc.compress_level(levels[k - 1])
            check(max_abs_err(levels[k], want) == 0,
                  f"level {k} differs from the plain compress")
            checked += 1
    check(checked > 0, "no level was checked")
    log(f"  plain compress on the {checked} levels of <= 2^14 nodes down to "
        "the cap: equal")


def phase_openings(batch, rng):
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.hash.merkle import verify_merkle_proof_to_cap
    tree = batch.merkle_tree
    idx = [int(i) for i in rng.integers(0, tree.num_leaves, NUM_QUERIES)]
    tree.prefetch(idx)
    for i in idx:
        row = tree.get(i)
        check(row.shape == (NUM_POLYS,), f"row {i} shape {row.shape}")
        check(verify_merkle_proof_to_cap(row, i, tree.cap, tree.prove(i)),
              f"opening {i} does not verify against the cap")
    log(f"  {len(idx)} openings verify against the cap")
    bad = tree.get(idx[0]).copy()
    bad[-1] = (int(bad[-1]) + 1) % P
    check(not verify_merkle_proof_to_cap(bad, idx[0], tree.cap,
                                         tree.prove(idx[0])),
          "a corrupted leaf verified")
    log("  leaf with one changed element: rejected")


def phase_quotient(dev, rng, full):
    """The quotient round at full width on the flagship shapes, fed the
    commitment path's witness and wires commitment, a commitment to 84
    random constants-sigmas polynomials, random sigmas, a seeded circuit
    digest and public inputs (ProverData), and the challenges of the
    port's transcript (the circuit's real data need its witness generators
    and circuit builder, which are not ported).  The kernels compute the
    same function on any inputs."""
    from plonky2_tpu_torch.fri.oracle import PolynomialBatch
    from plonky2_tpu_torch.hash import poseidon as pos
    from plonky2_tpu_torch.ops import ntt
    from plonky2_tpu_torch.plonk.constraint_program import linearize
    from plonky2_tpu_torch.plonk.prover import (quotient_round,
                                                start_transcript)
    prog, shape = flagship_program()
    note_program(prog, dev)
    check((shape.num_wires, shape.degree_bits, shape.rate_bits,
           shape.cap_height, shape.zero_knowledge)
          == (NUM_POLYS, LOG_N, RATE_BITS, CAP_HEIGHT, False),
          f"program file shape {shape}")
    n = 1 << LOG_N
    values, wires_batch = full["values"], full["batch"]
    cs_batch = PolynomialBatch.from_values(
        rand_field(rng, (shape.num_preprocessed_polys, n), dev), RATE_BITS,
        False, CAP_HEIGHT, device=dev)
    sigmas = rand_field(rng, (shape.num_routed_wires, n), dev)
    data = flagship_data(shape, prog, cs_batch.coeffs_dev, sigmas, rng)
    nch = shape.num_challenges
    pih = pos.hash_no_pad(np.array(data.public_inputs(values),
                                   dtype=np.uint64))
    challenger, betas, gammas = start_transcript(
        data, pih, wires_batch.merkle_tree.cap)
    drawn = []

    def alphas(zspp_batch):
        challenger.observe_cap(zspp_batch.merkle_tree.cap)
        drawn.append(challenger.get_n_challenges(nch))
        return drawn[-1]
    lin = linearize(prog)
    log(f"  program: {prog.n_inputs} inputs, {prog.n_regs} registers, "
        f"{prog.n_waves} waves x {prog.wave_width}, {prog.n_ops} real ops "
        f"({prog.n_mul_ops()} with a product); linear form: {lin.n_ops} ops "
        f"in {lin.n_slots} slots, {lin.n_read} inputs read; chunk "
        f"{QUOTIENT_CHUNK} lanes")

    def run(quotient):
        # the first run draws the alphas after the Z/PP cap; the warm runs
        # reuse them (the same values give the same cap)
        out = quotient_round(values, wires_batch, sigmas, shape, prog,
                             cs_batch, pih, betas, gammas,
                             alphas if quotient is None else drawn[0],
                             quotient=quotient, chunk=QUOTIENT_CHUNK,
                             device=dev)
        nat = ntt.lde_coset_ntt(out.zspp_batch.coeffs_dev, RATE_BITS)
        return out, nat

    (out, nat), res = timed_path(run, QUOTIENT_PATH, "quotient round",
                                 keep=lambda o: o[0].quotient)
    challenges = (pih, betas, gammas, drawn[0])
    log(f"  transcript: betas {betas}, gammas {gammas}, alphas {drawn[0]}")
    res["stages_ms"] = time_stages(out, values, wires_batch, sigmas, shape,
                                   challenges)
    res["profile"] = profile_run(lambda: run(out.quotient))
    sweep_chunks(out, wires_batch, challenges)
    check_quotient(out, nat, values, wires_batch, sigmas, shape, prog,
                   challenges, rng)
    res.update(data=data, challenger=challenger, out=out, cs_batch=cs_batch)
    return res


def flagship_data(shape, prog, cs_coeffs, sigmas, rng):
    """The ProverData of the flagship circuit's shape and program, with the
    given constants-sigmas coefficients and sigma values, the flagship FRI
    parameters and a seeded circuit digest."""
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
    from plonky2_tpu_torch.plonk.prover_data import ProverData
    fri = FriConfig(
        rate_bits=shape.rate_bits, cap_height=shape.cap_height,
        proof_of_work_bits=POW_BITS,
        reduction_strategy=FriReductionStrategy.ConstantArityBits(
            ARITY_BITS, FINAL_POLY_BITS),
        num_query_rounds=NUM_QUERIES).fri_params(shape.degree_bits,
                                                 shape.zero_knowledge)
    return ProverData(
        shape=shape,
        num_constants=shape.num_preprocessed_polys - shape.num_routed_wires,
        fri_params=fri, program=prog, cs_coeffs=cs_coeffs, sigmas=sigmas,
        circuit_digest=tuple(int(x) for x in rng.integers(
            0, P, size=4, dtype=np.uint64)),
        public_input_wires=PUBLIC_INPUT_WIRES)


def time_stages(out, values, wires_batch, sigmas, shape, challenges):
    """The quotient round's stages one by one, each timed with CUDA events
    on a warm context (the same calls quotient_round makes)."""
    from plonky2_tpu_torch.fri.oracle import PolynomialBatch
    from plonky2_tpu_torch.ops import ntt
    from plonky2_tpu_torch.ops.partial_products import \
        device_partial_products
    q = out.quotient
    _, betas, gammas, _ = challenges
    stages = {
        "partial products (plain torch)": lambda: device_partial_products(
            values, sigmas, betas, gammas, shape),
        "Z/PP commitment": lambda: PolynomialBatch.from_values(
            out.zspp_values, RATE_BITS, False, CAP_HEIGHT,
            device=values.device),
        "gather + K6": lambda: q.evaluate(wires_batch, out.zspp_batch,
                                          *challenges),
        "coset INTT": lambda: ntt.coset_intt(out.quotient_values),
        "quotient commitment": lambda: PolynomialBatch.from_coeffs(
            out.quotient_coeffs.reshape(shape.num_quotient_polys,
                                        shape.degree), RATE_BITS, False,
            CAP_HEIGHT, device=values.device),
        "natural-order LDE of Z/PP (K4)": lambda: ntt.lde_coset_ntt(
            out.zspp_batch.coeffs_dev, RATE_BITS),
    }
    res = {}
    for name, fn in stages.items():
        res[name], _ = cuda_ms(fn)
        log(f"  stage {name}: {res[name]:.3f} ms")
    return res


@contextlib.contextmanager
def device_trace(out: dict):
    """Trace the card's activity over the block with torch.profiler and
    put in `out` its wall, the device's busy time (the sum of its kernel,
    copy and memset times) and the copies.  Only the device's activity
    is traced: the host's torch ops would add their recording to the
    traced wall and their events to the summary (on a STARK proof, twice
    the events and their processing time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # rows of work that ran on the card (kernels, copies, memsets); the
    # runtime calls that launched them are not counted
    dev_ms = lambda e: getattr(  # noqa: E731
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)
    ) / 1e3
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_ms = sum(dev_ms(e) for e in events)
    for e in sorted(events, key=lambda e: -dev_ms(e))[:12]:
        log(f"  profile: {dev_ms(e):9.3f} ms device  {e.count:6d} calls  "
            f"{e.key[:90]}")
    copies = {e.key: [e.count, dev_ms(e)] for e in events
              if "memcpy" in e.key.lower()}
    for key, (count, ms) in copies.items():
        log(f"  profile: copies {key}: {count} calls, {ms:.3f} ms device")
    log(f"  profile: wall {wall_ms:.3f} ms (traced), device busy "
        f"{busy_ms:.3f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}" if busy_ms else
        "  profile: torch.profiler recorded no device time")
    out.update(wall_ms=wall_ms, busy_ms=busy_ms, copies=copies)


def profile_run(fn, warmup: bool = True) -> dict:
    """device_trace of one fn(), after one untraced fn() unless the
    caller has just run it (`warmup` False)."""
    if warmup:
        fn()
    out = {}
    with device_trace(out):
        fn()
    return out


def sweep_chunks(out, wires_batch, challenges):
    """Time the quotient's gather + K6 at each chunk size (CUDA events)."""
    q = out.quotient
    for C in CHUNK_SWEEP:
        ms, vals = cuda_ms(lambda: q.evaluate(wires_batch, out.zspp_batch,
                                              *challenges, chunk=C))
        check(bool((vals == out.quotient_values).all()),
              f"chunk {C} changed the quotient values")
        del vals
        log(f"  gather + K6 over the 2^21 lanes in chunks of {C}: {ms:.3f} ms")


def check_quotient(out, nat, values, wires_batch, sigmas, shape, prog,
                   challenges, rng):
    """Hold the quotient round's results against plain versions."""
    import torch
    from plonky2_tpu_torch.field import fft
    from plonky2_tpu_torch.utils.bits import bit_reverse_indices
    dev = values.device
    q = out.quotient
    N = q.lde_size
    check(tuple(out.quotient_values.shape) == (shape.num_challenges, N),
          "quotient values shape")
    check(tuple(out.quotient_batch.leaves_dev.shape)
          == (shape.num_quotient_polys, shape.degree << RATE_BITS),
          "quotient leaves shape")

    # K6 on lanes of the first and the last chunk, against the plain
    # interpreter on the same gathered inputs
    lanes = torch.cat([torch.arange(0, CHECK_LANES),
                       torch.arange(N - CHECK_LANES, N)]).to(dev)
    inputs = q.gather(lanes, wires_batch, out.zspp_batch)
    bank = q.scalar_bank(*challenges)
    want = prog.run_plain(inputs, bank)
    check(max_abs_err(want, out.quotient_values[:, lanes]) == 0,
          "K6 differs from the plain interpreter at full width")
    log(f"  K6 on {2 * CHECK_LANES} lanes of the first and last chunks: "
        "equal to the plain interpreter")

    # K3 (coset INTT): the plain coset NTT of the coefficients gives back
    # the values
    check(max_abs_err(fft.coset_fft(out.quotient_coeffs),
                      out.quotient_values) == 0,
          "plain coset NTT of the quotient coefficients differs")
    log("  plain coset NTT of the 2 x 2^21 quotient coefficients: equal to "
        "the values")

    # the quotient commitment: two chunk polynomials' LDE rows
    m = shape.degree << RATE_BITS
    perm = torch.from_numpy(bit_reverse_indices(m)).to(dev)
    rows = torch.tensor([0, shape.num_quotient_polys - 1], device=dev)
    coeffs = out.quotient_batch.coeffs_dev[rows]
    padded = torch.cat([coeffs, coeffs.new_zeros((2, m - shape.degree))], 1)
    check(max_abs_err(fft.coset_fft(padded)[:, perm],
                      out.quotient_batch.leaves_dev[rows]) == 0,
          "quotient leaf rows differ from the plain coset LDE")
    log("  2 quotient chunk polynomials: plain LDE equals the leaf rows")

    # K4 (natural order) against K5 (leaf order) on the 20 Z/PP polynomials
    check(bool((nat == out.zspp_batch.leaves_dev[:, perm]).all()),
          "natural-order LDE (K4) differs from the leaf-order LDE (K5)")
    log(f"  natural-order LDE (K4) of the {nat.shape[0]} Z/PP polynomials: "
        "equal to the bit reversal of their leaves (K5)")

    check_partial_products(out.zspp_values, values, sigmas, shape,
                           challenges, rng)


def check_partial_products(zspp, values, sigmas, shape, challenges, rng):
    """Z/PP values on sampled columns against Python integer arithmetic:
    Z(0) = 1, Z(j + 1) = Z(j) * prod_i numer_i(j) / denom_i(j), and each
    partial product is Z(j) times the cumulative chunk product."""
    import torch
    from plonky2_tpu_torch.field.convert import to_u64
    from plonky2_tpu_torch.field.goldilocks import P, primitive_root_of_unity
    _, betas, gammas, _ = challenges
    n, nr = shape.degree, shape.num_routed_wires
    qdf, npp, nch = (shape.quotient_degree_factor,
                     shape.num_partial_products, shape.num_challenges)
    cols = np.sort(rng.choice(n - 1, 64, replace=False))
    c = torch.from_numpy(cols).to(values.device)
    w = to_u64(values[:nr][:, c]).tolist()
    s = to_u64(sigmas[:, c]).tolist()
    z = to_u64(zspp[:, c]).tolist()
    z_next = to_u64(zspp[:nch][:, c + 1]).tolist()
    check(bool((zspp[:nch, 0] == 1).all()), "Z(0) != 1")
    g = primitive_root_of_unity(shape.degree_bits)
    for ch in range(nch):
        beta, gamma = betas[ch], gammas[ch]
        for j, col in enumerate(cols.tolist()):
            x = pow(g, col, P)
            cum, acc = [], 1
            for start in range(0, nr, qdf):
                num = den = 1
                for i in range(start, min(start + qdf, nr)):
                    num = num * (w[i][j] + beta * shape.k_is[i] * x
                                 + gamma) % P
                    den = den * (w[i][j] + beta * s[i][j] + gamma) % P
                acc = acc * num * pow(den, P - 2, P) % P
                cum.append(acc)
            check(z_next[ch][j] == z[ch][j] * cum[-1] % P,
                  f"Z step at column {col}, challenge {ch}")
            for i in range(npp):
                check(z[nch + ch * npp + i][j] == z[ch][j] * cum[i] % P,
                      f"partial product {i} at column {col}")
    log(f"  Z/PP values on {len(cols)} sampled columns: equal to integer "
        "arithmetic")


class StageTimer:
    """The prover's ``timing``: each stage's wall time between two
    synchronizations of the card, so host stages (the proof of work, the
    transcript) count as well as device ones."""

    def __init__(self):
        self.ms = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        import torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            self.ms[name] = (self.ms.get(name, 0.0)
                             + (time.perf_counter() - t) * 1e3)


class FriSpy:
    """Keeps what the last FRI proof computed, for the checks: the
    composition's arguments and result, each fold's input, beta (or its
    powers on the card) and output, the proof of work's duplex state,
    witness position, bits and witness, the layer trees and the query
    indices (wraps four functions of fri/device_prover.py and
    DeviceChallenger.grind; launches and results are untouched)."""
    NAMES = ("device_composition", "fold_coeffs", "fri_proof_of_work",
             "fri_prover_query_rounds")

    def __enter__(self):
        from plonky2_tpu_torch.fri import device_prover as tdp
        from plonky2_tpu_torch.hash import poseidon_cuda as pc
        from plonky2_tpu_torch.iop.challenger_torch import DeviceChallenger
        self.mod = tdp
        self.orig = {n: getattr(tdp, n) for n in self.NAMES}
        self.dc, self.dc_grind = DeviceChallenger, DeviceChallenger.grind

        def sponge_grind(dch, bits):
            # the grind's own flush first (the final polynomial); the
            # state stays on the card until the checks
            dch.flush()
            state, word = pc.duplex_input(dch.buf, dch.n_in), dch.n_in
            witness = self.dc_grind(dch, bits)
            self.grind = (state, word, bits, witness)
            return witness
        DeviceChallenger.grind = sponge_grind

        def composition(*args):
            out = self.orig["device_composition"](*args)
            self.composition, self.folds = (args, out), []
            return out

        def fold(coeffs, beta, arity):
            out = self.orig["fold_coeffs"](coeffs, beta, arity)
            self.folds.append((coeffs, beta, arity, out))
            return out

        def grind(challenger, config, device):
            state = (challenger.duplex_input_state(),
                     len(challenger.input_buffer), config.proof_of_work_bits)
            witness = self.orig["fri_proof_of_work"](challenger, config,
                                                     device)
            self.grind = state + (witness,)
            return witness

        def queries(initial, trees, indices, params):
            self.initial, self.trees = initial, trees
            self.indices = list(indices)
            return self.orig["fri_prover_query_rounds"](initial, trees,
                                                        indices, params)
        tdp.device_composition = composition
        tdp.fold_coeffs = fold
        tdp.fri_proof_of_work = grind
        tdp.fri_prover_query_rounds = queries
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.mod, n, f)
        self.dc.grind = self.dc_grind
        return False


@contextlib.contextmanager
def fri_path(path: str, counts: dict):
    """The opening proof's FRI through `path` ("fused" or "layered"); in
    each FRI (fri/device_prover.py:device_fri_proof, from the first
    layer's commit to the proof), counts the synchronising calls torch
    reports (torch.cuda.set_sync_debug_mode("warn")), the fused path's
    waits for its copies to the host (one a layer's cap, one the final
    download) and the host transcript's permutations."""
    import warnings
    import torch
    from plonky2_tpu_torch.fri import device_prover as tdp
    from plonky2_tpu_torch.hash import poseidon as pos
    inner = {"fused": tdp._device_fri_proof_fused,
             "layered": tdp._device_fri_proof_layered}[path]
    orig, orig_get, orig_perm = (tdp.device_fri_proof, tdp._HostCopy.get,
                                 pos.permute_ints)
    for k in ("syncs", "waits", "permutations", "calls"):
        counts.setdefault(k, 0)

    def get(copy):
        counts["waits"] += copy.event is not None
        return orig_get(copy)

    def permute(state):
        counts["permutations"] += 1
        return orig_perm(state)

    def counted(*args, **kwargs):
        counts["calls"] += 1
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            pos.permute_ints = permute
            try:
                return inner(*args, **kwargs)
            finally:
                pos.permute_ints = orig_perm
                torch.cuda.set_sync_debug_mode("default")
                counts["syncs"] += sum("synchroniz" in str(w.message)
                                       for w in seen)
    tdp.device_fri_proof, tdp._HostCopy.get = counted, get
    try:
        yield counts
    finally:
        tdp.device_fri_proof, tdp._HostCopy.get = orig, orig_get


def phase_opening_round(dev, full, quot):
    """The opening round at full width on the two rounds' commitments: the
    transcript after the quotient round observes the quotient cap, draws
    zeta, opens the 354 polynomials and proves them with FRI (four layers
    of arity 16, 16 bits of proof of work, 28 queries).  One cold run
    (counted), WARM_RUNS warm runs (timed per kernel), the stages one by
    one, one traced run, then the checks."""
    import copy
    from plonky2_tpu_torch.plonk.prover import opening_round
    from plonky2_tpu_torch.utils.serialization import proof_words
    data, out = quot["data"], quot["out"]
    fp = data.fri_params
    check(set(fp.reduction_arity_bits) == {ARITY_BITS}
          and fp.final_poly_bits() <= FINAL_POLY_BITS, f"FRI params {fp}")
    oracles = [quot["cs_batch"], full["batch"], out.zspp_batch,
               out.quotient_batch]
    log(f"  {sum(o.coeffs_dev.shape[0] for o in oracles)} polynomials in 4 "
        f"oracles; FRI arities {[1 << b for b in fp.reduction_arity_bits]}, "
        f"final polynomial {fp.final_poly_len()} coefficients, "
        f"{fp.config.num_query_rounds} queries, proof of work "
        f"{fp.config.proof_of_work_bits} bits")

    def run(_, timing=None):
        return opening_round(copy.deepcopy(quot["challenger"]), oracles,
                             data, timing)

    with FriSpy() as spy:
        (openings, proof), res = timed_path(run, OPENING_PATH,
                                            "opening round")
        res["merkle_levels"] = log_merkle_levels(res)
        res["fri_paths"] = {}
        for path in ("layered", "fused"):
            # each stage synchronises: its own run, not counted
            with fri_path(path, {}):
                timer = StageTimer()
                t = time.perf_counter()
                with count_host_permutations() as perms:
                    run(None, timer)
                log(f"  {path} FRI, stages:")
                log_stages(timer, time.perf_counter() - t)
            counts = {}
            with fri_path(path, counts):
                other = run(None)
            check(list(proof_words(other)) == list(proof_words(
                (openings, proof))), f"the {path} FRI's proof differs")
            check(counts.pop("calls") == 1, "one FRI a run")
            log(f"  {path} FRI: the proof equals the first run's; in the "
                f"FRI part {counts['syncs']} synchronising calls (torch's "
                f"sync debug mode), {counts['waits']} waits for copies, "
                f"{counts['permutations']} host permutations (the whole "
                f"round: {perms[0]})")
            res["fri_paths"][path] = {"stages_ms": timer.ms,
                                      "round_permutations": perms[0],
                                      **counts}
        res["stages_ms"] = timer.ms
        res["host"] = log_host_hashing(perms[0])
        res["profile"] = profile_run(lambda: run(None))
        check(list(proof_words(run(None))) == list(proof_words(
            (openings, proof))), "two runs of the opening round differ")
        res["grind"] = check_grind_on_cpu(spy, proof)
        check_query_paths(spy, proof, fp)
        check_composition(spy)
        check_folds(spy, proof, fp)
    res.update(openings=openings, proof=proof)
    return res


@contextlib.contextmanager
def count_host_permutations():
    """Counts the host transcript's permutations (hash/poseidon.py:
    permute_ints) while the block runs; yields a one-element list."""
    from plonky2_tpu_torch.hash import poseidon as pos
    orig, count = pos.permute_ints, [0]

    def counted(state):
        count[0] += 1
        return orig(state)
    pos.permute_ints = counted
    try:
        yield count
    finally:
        pos.permute_ints = orig


def log_host_hashing(n_perms: int) -> dict:
    """The host transcript's permutations and their rate on this machine
    (hash/poseidon.py:permute_ints)."""
    from plonky2_tpu_torch.hash import poseidon as pos
    state = list(range(12))
    t = time.perf_counter()
    for _ in range(200):
        pos.permute_ints(state)
    scalar_ms = (time.perf_counter() - t) * 1e3 / 200
    log(f"  host: {n_perms} transcript permutations at {scalar_ms:.3f} ms "
        f"each ({n_perms * scalar_ms:.1f} ms)")
    return {"transcript_permutations": n_perms, "scalar_ms": scalar_ms}


def check_grind_on_cpu(spy, proof) -> dict:
    """K8's witness (the proof's) against K8's plain version on the CPU
    from the same duplex state, position and bits; the plain version's
    time there."""
    from plonky2_tpu_torch.field.convert import from_u64, to_u64
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    state, word, bits, witness = spy.grind
    if not isinstance(witness, int):    # the fused FRI's, on the card
        state = [int(x) for x in to_u64(state)]
        witness = int(to_u64(witness)[0])
    check(witness == proof.pow_witness, "the spied grind is not the proof's")
    t = time.perf_counter()
    plain = pc.pow_grind(from_u64(np.array(state, dtype=np.uint64)), word,
                         bits)
    cpu_s = time.perf_counter() - t
    check(plain == witness, f"K8 found {witness}, its plain version on the "
          f"CPU {plain}")
    log(f"  proof of work: K8's witness {witness} (word {word}, {bits} "
        f"bits) equals the plain version's on the CPU ({cpu_s:.2f} s there, "
        f"{witness + 1} permutations)")
    return {"witness": witness, "word": word, "bits": bits,
            "cpu_plain_s": cpu_s}


def log_stages(timer, wall_s):
    for name, ms in timer.ms.items():
        log(f"  stage {name}: {ms:.3f} ms")
    log(f"  stages sum {sum(timer.ms.values()):.3f} ms of a {wall_s:.4f} s "
        "run (each stage between two synchronizations)")


def check_query_paths(spy, proof, fp):
    """Every query's rows and paths, in the initial trees and the layer
    trees, verify against their caps; a changed value does not."""
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.hash.merkle import verify_merkle_proof_to_cap
    check(len(spy.indices) == len(proof.query_round_proofs)
          == fp.config.num_query_rounds, "query count")
    n_paths = 0
    for x, r in zip(spy.indices, proof.query_round_proofs):
        for t, (row, path) in zip(spy.initial,
                                  r.initial_trees_proof.evals_proofs):
            check(verify_merkle_proof_to_cap(row, x, t.cap, path),
                  f"initial tree path of query {x}")
            n_paths += 1
        xi = x
        for tree, step, ab in zip(spy.trees, r.steps,
                                  fp.reduction_arity_bits):
            xi >>= ab
            check(verify_merkle_proof_to_cap(step.evals.reshape(-1), xi,
                                             tree.cap, step.merkle_proof),
                  f"layer path of query {x}")
            n_paths += 1
    step = proof.query_round_proofs[0].steps[0]
    bad = step.evals.copy()
    bad[0, 0] = (int(bad[0, 0]) + 1) % P
    check(not verify_merkle_proof_to_cap(
        bad.reshape(-1), spy.indices[0] >> fp.reduction_arity_bits[0],
        spy.trees[0].cap, step.merkle_proof), "a changed layer value verified")
    log(f"  {n_paths} query paths verify against their caps; a changed "
        "value does not")


def check_composition(spy):
    """The composition at CHECK_POINTS leaf positions against Python
    integer arithmetic from the committed leaves, and its coefficients
    against the plain coset NTT."""
    import torch
    from plonky2_tpu_torch.field import extension as ext
    from plonky2_tpu_torch.field import fft
    from plonky2_tpu_torch.field.convert import to_u64
    from plonky2_tpu_torch.fri import device_prover as tdp
    (instance, oracles, alpha, batches, lde_bits), (vals, coeffs) = \
        spy.composition
    dev = coeffs.device
    N = 1 << lde_bits
    rng = np.random.default_rng(SEED + 2)
    js = [0, N - 1] + [int(j) for j in rng.integers(0, N, CHECK_POINTS - 2)]
    jt = torch.tensor(js, device=dev)
    xs = [int(x) for x in to_u64(tdp.xs_br(lde_bits, str(dev))[jt])]
    leaves = [to_u64(o.leaves_dev[:, jt]) for o in oracles]
    got = list(zip(*(to_u64(v[jt]) for v in vals)))
    for k, x in enumerate(xs):
        comp = (0, 0)
        for batch, claimed in zip(instance.batches, batches):
            r, rz, a = (0, 0), (0, 0), (1, 0)
            for info, y in zip(batch.polynomials, claimed.values):
                leaf = int(leaves[info.oracle_index][info.polynomial_index, k])
                r = ext.s_add(r, ext.s_mul(a, (leaf, 0)))
                rz = ext.s_add(rz, ext.s_mul(a, y))
                a = ext.s_mul(a, alpha)
            q = ext.s_mul(ext.s_sub(r, rz),
                          ext.s_inv(ext.s_sub((x, 0), batch.point)))
            comp = ext.s_add(ext.s_mul(comp, a), q)
        want = ext.s_mul(comp, (x, 0))
        check(tuple(int(v) for v in got[k]) == want,
              f"composition at leaf {js[k]}")
    natural = torch.stack([v[tdp.bitrev_perm(N, str(dev))] for v in vals])
    check(max_abs_err(fft.coset_fft(coeffs), natural) == 0,
          "plain coset NTT of the composition's coefficients differs")
    log(f"  composition at {len(js)} leaves equal to integer arithmetic over "
        f"the {sum(len(b.polynomials) for b in instance.batches)} opened "
        "leaves; plain coset NTT of its 2 x 2^"
        f"{lde_bits} coefficients equal to its values")


def check_folds(spy, proof, fp):
    """Each fold at CHECK_POINTS outputs against integer arithmetic; each
    layer tree's leaves against the composition's values (layer 0) or the
    plain coset NTT of the previous fold (K5's leaf order); the final
    polynomial is the last fold's head and its tail is zero."""
    import torch
    from plonky2_tpu_torch.field import extension as ext
    from plonky2_tpu_torch.field import fft
    from plonky2_tpu_torch.field.convert import to_u64
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.fri import device_prover as tdp
    rng = np.random.default_rng(SEED + 3)
    (_, (vals, _)) = spy.composition
    check(len(spy.folds) == len(spy.trees) == len(fp.reduction_arity_bits),
          "fold count")
    shift = 7
    for i, ((coeffs, beta, arity, out), tree) in enumerate(
            zip(spy.folds, spy.trees)):
        if isinstance(beta, torch.Tensor):      # beta's powers from K9
            check(arity > 1, "no beta in the powers of an arity-1 fold")
            beta = tuple(int(x) for x in to_u64(beta[:, 1]))
        if i == 0:
            prev = vals
        else:
            prev_out = spy.folds[i - 1][3]
            values = fft.coset_fft(prev_out, shift)
            perm = tdp.bitrev_perm(values.shape[1], str(values.device))
            prev = (values[0][perm], values[1][perm])
        m = prev[0].shape[0] // arity
        want = torch.stack([prev[0].reshape(m, arity),
                            prev[1].reshape(m, arity)], -1).reshape(m, -1).T
        check(max_abs_err(tree.leaves_dev, want) == 0,
              f"layer {i} leaves differ")
        shift = pow(shift, arity, P)
        host_in, host_out = to_u64(coeffs), to_u64(out)
        for j in [0, host_out.shape[1] - 1] + [
                int(x) for x in rng.integers(0, host_out.shape[1],
                                             CHECK_POINTS - 2)]:
            acc, b = (0, 0), (1, 0)
            for t in range(arity):
                c = (int(host_in[0, j * arity + t]),
                     int(host_in[1, j * arity + t]))
                acc = ext.s_add(acc, ext.s_mul(b, c))
                b = ext.s_mul(b, beta)
            check((int(host_out[0, j]), int(host_out[1, j])) == acc,
                  f"fold {i} output {j}")
    last = to_u64(spy.folds[-1][3])
    fl = fp.final_poly_len()
    check(not last[:, fl:].any() and (proof.final_poly == last[:, :fl].T)
          .all(), "final polynomial")
    log(f"  {len(spy.folds)} folds equal to integer arithmetic at "
        f"{CHECK_POINTS} outputs each; every layer tree's leaves equal to "
        f"the plain coset NTT in leaf order; final polynomial "
        f"{fl} coefficients, tail of {last.shape[1] - fl} zero")


def phase_prove(dev, full, quot, opening):
    """The whole proof after the witness (plonk/prover.py:prove, phases
    2-8) at full width, on phase 4's witness and phase 6's circuit data:
    one cold run (counted), WARM_RUNS warm runs, the stages, one traced
    run; its proof must equal what phases 4, 6 and 7 made step by step,
    and its query paths verify."""
    import torch
    from plonky2_tpu_torch.plonk.prover import ProverContext, prove
    from plonky2_tpu_torch.utils.serialization import proof_words
    data, values = quot["data"], full["values"]
    note_program(data.program, dev)
    t = time.perf_counter()
    ctx = ProverContext(data, dev)
    torch.cuda.synchronize()
    log(f"  prover context (constants-sigmas commitment, quotient context): "
        f"{time.perf_counter() - t:.3f} s")

    def run(_, timing=None):
        return prove(data, values, context=ctx, device=dev, timing=timing)

    with FriSpy() as spy:
        proof, res = timed_path(run, PROVE_PATH, "prove (phases 2-8)")
        check_query_paths(spy, proof.proof.opening_proof, data.fri_params)
        timer = StageTimer()
        t = time.perf_counter()
        run(None, timer)
        log_stages(timer, time.perf_counter() - t)
        res["stages_ms"] = timer.ms
        res["profile"] = profile_run(lambda: run(None))
    p = proof.proof
    check(list(proof_words([p.openings, p.opening_proof])) == list(
        proof_words([opening["openings"], opening["proof"]])),
        "prove differs from the phases run one by one")
    check((p.wires_cap.digests == full["batch"].merkle_tree.cap.digests)
          .all() and (p.quotient_polys_cap.digests == quot["out"]
                      .quotient_batch.merkle_tree.cap.digests).all(),
          "prove's caps differ from phases 4 and 6")
    log(f"  proof: {len(list(proof_words(proof)))} field elements and "
        "numbers, equal to phases 4, 6 and 7's; public inputs "
        f"{proof.public_inputs}")
    return res


def phase_reduced(dev, rng):
    """At 2^REDUCED_LOG_N rows (the flagship's widths and program, random
    inputs), the card's proof equals the one this machine makes with
    device="cpu" (the plain versions)."""
    import dataclasses
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.utils.serialization import proof_words
    prog, shape = flagship_program()
    shape = dataclasses.replace(shape, degree_bits=REDUCED_LOG_N)
    n = shape.degree
    draw = lambda rows: rng.integers(0, P, size=(rows, n),  # noqa: E731
                                     dtype=np.uint64)
    data = flagship_data(shape, prog, draw(shape.num_preprocessed_polys),
                         draw(shape.num_routed_wires), rng)
    witness = draw(shape.num_wires)
    proofs = {}
    for where in (dev, "cpu"):
        t = time.perf_counter()
        proofs[str(where)] = list(proof_words(prove(data, witness,
                                                    device=where)))
        log(f"  proof at 2^{REDUCED_LOG_N} rows on {where}: "
            f"{time.perf_counter() - t:.2f} s, "
            f"{len(proofs[str(where)])} numbers")
    check(proofs[str(dev)] == proofs["cpu"],
          "the card's proof differs from the CPU's")
    log("  the card's proof equals the CPU's, number for number")


def host_rss_gib() -> tuple:
    """(current, peak since the process started) resident memory of this
    process in GiB."""
    import resource
    with open("/proc/self/statm") as f:
        cur = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return cur / 2**30, peak / 2**30


def phase_session(dev) -> dict:
    """The port's entry points on the flagship circuit, on their default
    device (cuda, the current card `dev`): the port's CircuitBuilder
    builds the 2^SESSION_LOG2_LEAVES-leaf hash tree under
    CircuitConfig.wide_ecc_config() (2^18 rows, the constants-sigmas
    commitment on the card; launches counted), its circuit digest, cap and
    root held equal to the JAX package's pinned circuit (FLAGSHIP_REF);
    then ProverSession.prove, one cold run (counted; it builds the device
    witness plan, stage "witness plan") and WARM_RUNS warm runs (timed per
    kernel), each from random.Random(0), so all give one proof, the pinned
    FLAGSHIP_PROOF_SHA256.  Every run's witness must come from the plan
    (stage "device witness", K7 launched; the host engine's stage
    "witness" absent), and the plan's wires once equal the host engine's
    full_witness(); every proof verified with the port's verifier, and a
    copy with one opened value changed rejected."""
    import collections
    import copy
    import hashlib
    import random
    import torch
    from plonky2_tpu_torch.fri.verifier import FriVerificationError
    from plonky2_tpu_torch.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.kernels import named_args
    from plonky2_tpu_torch.plonk.verifier import ProofVerificationError
    from plonky2_tpu_torch.runtime.session import ProverSession
    from plonky2_tpu_torch.utils.serialization import serialize_proof
    with open(FLAGSHIP_REF) as f:
        ref = json.load(f)

    rss = host_rss_gib()
    log(f"  host RSS before the build {rss[0]:.2f} GiB (peak so far "
        f"{rss[1]:.2f})")
    torch.cuda.synchronize()
    reset_launch_counts()
    build_timer = StageTimer()
    t = time.perf_counter()
    with KernelRecorder() as rec:
        data, pw, root = build_hash_tree_circuit(
            CircuitConfig.wide_ecc_config(), SESSION_LOG2_LEAVES, seed=SEED,
            timing=build_timer)
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    launches = read_launch_counts()
    for entry in COMMIT_PATH:
        check(launches[entry] > 0, f"{entry} was not launched by build()")
    build = {"cold_s": build_s, "warm_s": [build_s], "launches": launches,
             "kernel_ms": rec.ms_by_kernel(), "cost": path_cost(rec.records),
             "stages_ms": build_timer.ms}
    common, po = data.common, data.prover_only
    rss = host_rss_gib()
    log(f"  build: {build_s:.3f} s, {common.degree()} rows, "
        f"{len(po.generators)} generators, {len(po.representative_map)} "
        f"forest slots; host RSS {rss[0]:.2f} GiB (peak {rss[1]:.2f}); "
        f"launches {launches}")
    log_stages(build_timer, build_s)
    ints = lambda a: [int(x) for x in np.asarray(a).reshape(-1)]  # noqa: E731
    check(common.degree_bits() == ref["degree_bits"] == LOG_N
          and common.config.num_wires == NUM_POLYS, "flagship shape")
    check(ints(po.circuit_digest) == ref["circuit_digest"],
          "circuit digest differs from the JAX package's flagship circuit")
    check([ints(d) for d in data.verifier_only.constants_sigmas_cap.digests]
          == ref["constants_sigmas_cap"], "constants-sigmas cap differs")
    check(root == ref["root"], "expected root differs")
    log(f"  circuit digest {ints(po.circuit_digest)} and the 16 cap digests "
        "equal the JAX package's pinned flagship circuit; root equal")
    classes = collections.Counter(type(g).__name__ for g in po.generators)
    log(f"  generators per class: {dict(classes)}")

    t = time.perf_counter()
    session_timer = StageTimer()
    sess = ProverSession(data, timing=session_timer)
    torch.cuda.synchronize()
    session_s = time.perf_counter() - t
    check(sess.context.cs_batch is po.constants_sigmas_commitment,
          "the session committed the constants-sigmas again")
    compile_ms = session_timer.ms["quotient program"]
    check_flagship_program(sess.prover_data.program)
    note_program(sess.prover_data.program, dev)
    log(f"  ProverSession: {session_s:.3f} s (stage quotient program "
        f"{compile_ms:.3f} ms: the compiled program equals "
        "plonk/programs/hash_tree_wide_ecc.npz array for array; build()'s "
        "constants-sigmas commitment)")

    def run(timer):
        return sess.prove(pw, rng=random.Random(0), timing=timer)

    def witness_s(timer):
        return sum(timer.ms.get(k, 0.0) for k in (
            "witness plan", "device witness", "witness")) / 1e3

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    runs = []
    for i in range(1 + WARM_RUNS):
        timer = StageTimer()
        with contextlib.ExitStack() as stack:
            rec = stack.enter_context(KernelRecorder()) if i else None
            t = time.perf_counter()
            proof = run(timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        if not i:
            launches = read_launch_counts()
            for entry in SESSION_PATH:
                check(launches[entry] > 0,
                      f"{entry} was not launched by ProverSession.prove")
            check(launches["plk_poseidon_wires_waves"] == 1,
                  "the flagship's Poseidon waves took "
                  f"{launches['plk_poseidon_wires_waves']} K7 launches")
            check("witness plan" in timer.ms, "the cold proof built no "
                  "witness plan")
        else:
            ms = rec.ms_by_kernel()
            check("plk_poseidon_wires_waves" in ms and "plk_pow_grind" in ms
                  and "witness plan" not in timer.ms,
                  "a warm proof did not run the kept plan's K7 waves and "
                  "the K8 grind")
        check("device witness" in timer.ms and "witness" not in timer.ms,
              "the flagship's witness did not come from the device plan")
        check(proof.public_inputs == ref["root"], "public inputs != root")
        t = time.perf_counter()
        sess.verify(proof)
        verify_s = time.perf_counter() - t
        blob = serialize_proof(proof)
        wit = witness_s(timer)
        runs.append({"wall_s": wall, "witness_s": wit, "verify_s": verify_s,
                     "stages_ms": timer.ms, "bytes": len(blob),
                     "sha256": hashlib.sha256(blob).hexdigest(),
                     "kernel_ms": rec.ms_by_kernel() if rec else None,
                     "records": rec.records if rec else None})
        log(f"  prove {'cold' if not i else 'warm'}: {wall:.4f} s, without "
            f"the witness {wall - wit:.4f} s (witness {wit:.4f} s: "
            + ", ".join(f"{k} {timer.ms[k]:.3f} ms" for k in (
                "witness plan", "device witness") if k in timer.ms)
            + f"); verify "
            f"{verify_s:.3f} s; proof {len(blob)} bytes, sha256 "
            f"{runs[-1]['sha256']}; host RSS peak {host_rss_gib()[1]:.2f} "
            "GiB")
    peak = torch.cuda.max_memory_allocated()
    log_stages(timer, runs[-1]["wall_s"])
    profile = profile_run(lambda: run(None))
    check({r["sha256"] for r in runs} == {FLAGSHIP_PROOF_SHA256},
          "the session's proofs differ from the pinned flagship proof")
    log(f"  every proof's sha256 is the pinned {FLAGSHIP_PROOF_SHA256}")
    plan_check = check_plan_witness(sess, pw, dev)
    bad = copy.deepcopy(proof)
    bad.proof.openings.wires[0, 0] = (int(bad.proof.openings.wires[0, 0])
                                      + 1) % (2**64 - 2**32 + 1)
    try:
        sess.verify(bad)
    except (ProofVerificationError, FriVerificationError) as e:
        log(f"  a proof with one opened value changed is rejected: {e}")
    else:
        raise RuntimeError("check failed: a corrupted proof verified")
    warm = runs[1:]
    secs = lambda xs: ", ".join(f"{x:.4f}" for x in xs)  # noqa: E731
    log(f"  ProverSession.prove warm (s): "
        f"{secs(r['wall_s'] for r in warm)}; without the witness "
        f"{secs(r['wall_s'] - r['witness_s'] for r in warm)}; cold "
        f"{runs[0]['wall_s']:.4f}; peak max_memory_allocated "
        f"{peak / 2**30:.3f} GiB")
    kernel_ms = {k: float(np.median([r["kernel_ms"].get(k, 0.0)
                                     for r in warm]))
                 for k in warm[-1]["kernel_ms"]}
    cost = path_cost(warm[-1]["records"], pow_witness_of(proof))
    k7_waves = sum(named_args(n, a)["n_waves"]
                   for n, a, _, _ in warm[-1]["records"]
                   if n == "plk_poseidon_wires_waves")
    log(f"  K7 on a warm proof: {k7_waves} waves, "
        f"{kernel_ms.get('plk_poseidon_wires_waves', 0.0):.4f} ms; K8: "
        f"{kernel_ms.get('plk_pow_grind', 0.0):.4f} ms for witness "
        f"{pow_witness_of(proof)}; K9: "
        f"{kernel_ms.get('plk_sponge', 0.0):.4f} ms in "
        f"{sum(n == 'plk_sponge' for n, _, _, _ in warm[-1]['records'])} "
        f"launches, {cost['plk_sponge'][1] // PERM_MULS} permutations")
    k8_record = grind_record(dev)
    for r in runs:
        del r["records"], r["kernel_ms"]
    session = {"cold_s": runs[0]["wall_s"],
               "warm_s": [r["wall_s"] for r in warm], "launches": launches,
               "kernel_ms": kernel_ms, "cost": cost, "peak_bytes": peak,
               "runs": runs, "session_s": session_s, "profile": profile,
               "generators": dict(classes), "host_rss_gib": host_rss_gib(),
               "plan_check": plan_check, "k7_waves": k7_waves,
               "k8_record": k8_record, "compile_ms": compile_ms}
    return {"build": build, "session": session}


def check_flagship_program(prog) -> None:
    """A compiled program equals the shipped flagship program (the JAX
    compiler's output), array for array."""
    shipped, _ = flagship_program()
    got = prog.arrays()
    for k, v in shipped.arrays().items():
        check(np.array_equal(np.asarray(got[k]), np.asarray(v)),
              f"the compiled flagship program differs in {k}")


def prove_session(sess, pw, path, label, want_sha, device_witness,
                  want_pis=None, warm_runs=WARM_RUNS, trace=True,
                  prove=None) -> tuple:
    """ProverSession.prove of `pw` (or `prove(rng, timing)`, an entry
    point that proves in `sess`): one cold run (launch counts set to 0
    just before and read just after; every kernel of `path` launched) and
    `warm_runs` warm runs (timed per kernel; with none, the cold run is
    timed per kernel), each from random.Random(0)
    and each verified with the port's verifier; every proof's sha256 must
    be `want_sha`.  The witness comes from the device plan (stage "device
    witness", K7) when `device_witness`, else from the host engine (stage
    "witness").  Where `trace`, the last run is traced for the idle share
    (device_trace; the card's activity only, so the run's wall moves
    little).  Returns the path's numbers and the proof."""
    import hashlib
    import random
    import torch
    from plonky2_tpu_torch.utils.serialization import serialize_proof
    if prove is None:
        def prove(rng, timing=None):
            return sess.prove(pw, rng=rng, timing=timing)
    note_program(sess.prover_data.program, sess.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    runs, recs, profile = [], None, None
    for i in range(1 + warm_runs):
        timer = StageTimer()
        with contextlib.ExitStack() as stack:
            rec = stack.enter_context(KernelRecorder()) \
                if i or not warm_runs else None
            if trace and i == warm_runs:
                profile = {}
                stack.enter_context(device_trace(profile))
            t = time.perf_counter()
            proof = prove(random.Random(0), timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        if not i:
            launches = read_launch_counts()
            for entry in path:
                check(launches[entry] > 0,
                      f"{entry} was not launched on the {label}")
        if rec is not None:
            recs = rec.records
        want, other = (("device witness", "witness") if device_witness
                       else ("witness", "device witness"))
        check(want in timer.ms and other not in timer.ms,
              f"the {label}'s witness did not come from the {want} stage")
        if want_pis is not None:
            check(proof.public_inputs == want_pis, "public inputs differ")
        t = time.perf_counter()
        sess.verify(proof)
        verify_s = time.perf_counter() - t
        blob = serialize_proof(proof)
        runs.append({"wall_s": wall, "verify_s": verify_s,
                     "stages_ms": timer.ms, "bytes": len(blob),
                     "sha256": hashlib.sha256(blob).hexdigest(),
                     "kernel_ms": rec.ms_by_kernel() if rec else None})
        wit = sum(timer.ms.get(k, 0.0) for k in (
            "witness plan", "device witness", "witness")) / 1e3
        log(f"  {label} prove {'cold' if not i else 'warm'}: {wall:.4f} s "
            f"(witness {wit:.4f} s); verify {verify_s:.3f} s; proof "
            f"{len(blob)} bytes, sha256 {runs[-1]['sha256']}")
    peak = torch.cuda.max_memory_allocated()
    log_stages(timer, runs[-1]["wall_s"])
    log(f"  {label}: peak max_memory_allocated {peak / 2**30:.3f} GiB")
    shas = {r["sha256"] for r in runs}
    check(shas == {want_sha}, f"the {label}'s proofs ({shas}) are not the "
          f"pinned {want_sha}")
    log(f"  every {label} proof's sha256 is the pinned {want_sha}")
    timed = runs[1:] or runs
    kernel_ms = {k: float(np.median([r["kernel_ms"].get(k, 0.0)
                                     for r in timed]))
                 for k in timed[-1]["kernel_ms"]}
    for r in runs:
        del r["kernel_ms"]
    return {"cold_s": runs[0]["wall_s"],
            "warm_s": [r["wall_s"] for r in runs[1:]],
            "launches": launches, "kernel_ms": kernel_ms,
            "cost": path_cost(recs, pow_witness_of(proof)),
            "peak_bytes": peak, "runs": runs, "profile": profile}, proof


def k6_form_of(sess) -> dict:
    from plonky2_tpu_torch.plonk import constraint_program as cp
    from plonky2_tpu_torch.plonk.constraint_program_cuda import k6_form
    prog = sess.prover_data.program
    lin = cp.linearize(prog)
    form = k6_form(lin.n_slots, max(1, len(prog.bank_sids)))
    return {"ops": lin.n_ops, "slots": lin.n_slots,
            "bank": len(prog.bank_sids), "lanes": form.lanes,
            "n_shared": form.n_shared, "n_spilled": form.n_spilled}


def phase_standard(dev) -> dict:
    """The flagship's tree (2^SESSION_LOG2_LEAVES leaves, numpy seed 0)
    under CircuitConfig.standard_recursion_config() (135 wires, 2^18
    rows): built by the port on the card, its quotient program compiled by
    the session, its witness from the device plan (K7), proved cold and
    warm and verified; every proof the pinned STANDARD_PROOF_SHA256 (the
    proof scripts/jax_verify_flagship_proof.py --config standard accepts
    with the JAX package's verifier against the port's cap).  First the
    port builds the same tree at 2^10 leaves on the card, and its circuit
    digest, cap and root must equal the JAX package's (STANDARD_REF)."""
    import torch
    from plonky2_tpu_torch.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.runtime.session import ProverSession
    with open(STANDARD_REF) as f:
        ref = json.load(f)
    t = time.perf_counter()
    small, _, root = build_hash_tree_circuit(
        CircuitConfig.standard_recursion_config(), ref["log2_leaves"],
        seed=SEED)
    ints = lambda a: [int(x) for x in np.asarray(a).reshape(-1)]  # noqa: E731
    check(small.common.degree_bits() == ref["degree_bits"]
          and ints(small.prover_only.circuit_digest) == ref["circuit_digest"]
          and [ints(d) for d in small.verifier_only.constants_sigmas_cap
               .digests] == ref["constants_sigmas_cap"]
          and root == ref["root"], "the port's standard tree at "
          f"2^{ref['log2_leaves']} leaves differs from the JAX package's")
    log(f"  the tree at 2^{ref['log2_leaves']} leaves, built on the card in "
        f"{time.perf_counter() - t:.3f} s: circuit digest, cap and root "
        "equal the JAX package's build (plonk/programs/"
        "hash_tree_standard_k10.json)")
    del small
    reset_launch_counts()
    build_timer = StageTimer()
    t = time.perf_counter()
    data, pw, root = build_hash_tree_circuit(
        CircuitConfig.standard_recursion_config(), SESSION_LOG2_LEAVES,
        seed=SEED, timing=build_timer)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    check(data.common.degree_bits() == LOG_N
          and data.common.config.num_wires == 135, "standard tree shape")
    log(f"  build: {build_s:.3f} s, {data.common.degree()} rows, "
        f"{data.common.config.num_wires} wires; launches "
        f"{read_launch_counts()}")
    log_stages(build_timer, build_s)
    timer = StageTimer()
    sess = ProverSession(data, timing=timer)
    form = k6_form_of(sess)
    log(f"  quotient program compiled in {timer.ms['quotient program']:.3f}"
        f" ms: {form}")
    res = prove_session(sess, pw, SESSION_PATH, "standard tree",
                        STANDARD_PROOF_SHA256, True, root,
                        warm_runs=EARLIER_WARM_RUNS)[0]
    res.update(build_s=build_s, build_stages_ms=build_timer.ms,
               compile_ms=timer.ms["quotient program"], k6_form=form)
    return res


def phase_gate_mix(dev) -> dict:
    """The gate mix (models/gate_mix.py: every gate of the recursion set)
    at 2^12 rows under standard_recursion_config: built by the port on the
    card, its program compiled, the device witness plan refused (the host
    engine runs), proved cold and warm and verified; every proof the
    pinned GATE_MIX_PROOF_SHA256, the port's CPU proof of the same circuit
    and seed."""
    import torch
    from plonky2_tpu_torch.iop import device_witness as dw
    from plonky2_tpu_torch.models.gate_mix import build_gate_mix_circuit
    from plonky2_tpu_torch.runtime.session import ProverSession
    reset_launch_counts()
    t = time.perf_counter()
    data, pw, n_gates = build_gate_mix_circuit(copies=GATE_MIX_COPIES,
                                               seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    gates = [g.id().split(" ")[0].split("(")[0] for g in data.common.gates]
    check(data.common.degree_bits() == GATE_MIX_LOG_N,
          f"the gate mix has 2^{data.common.degree_bits()} rows")
    log(f"  build: {build_s:.3f} s, {n_gates} gates in "
        f"{data.common.degree()} rows; {len(gates)} gate types {gates}")
    timer = StageTimer()
    sess = ProverSession(data, timing=timer)
    check(dw.build_plan(data.prover_only, data.common, pw, dev) is None,
          "the device witness plan took the gate mix")
    form = k6_form_of(sess)
    log(f"  quotient program compiled in {timer.ms['quotient program']:.3f}"
        f" ms: {form}; the device witness plan refuses the circuit")
    res = prove_session(sess, pw, GATE_MIX_PATH, "gate mix",
                        GATE_MIX_PROOF_SHA256, False,
                        warm_runs=EARLIER_WARM_RUNS)[0]
    res.update(build_s=build_s, compile_ms=timer.ms["quotient program"],
               k6_form=form, gates=gates, n_gates=n_gates)
    return res


def prove_stark_path(label, prove, keys, want_sha,
                     warm_runs=WARM_RUNS) -> tuple:
    """A STARK path's proof, `prove(timing)`: one cold run (launch counts
    set to 0 just before and read just after; each TPU kernel of `keys`
    launched in some form) and `warm_runs` warm runs (timed per kernel),
    every proof's sha256 over its proof_words the pinned `want_sha`; then
    one traced warm run for the idle share.  Returns (the path's numbers,
    the last proof)."""
    import torch
    from plonky2_tpu_torch.utils.serialization import (proof_sha256,
                                                       proof_words)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    runs, recs = [], None
    for i in range(1 + warm_runs):
        timer = StageTimer()
        with contextlib.ExitStack() as stack:
            rec = stack.enter_context(KernelRecorder()) if i else None
            t = time.perf_counter()
            proof = prove(timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        if not i:
            launches = read_launch_counts()
            for key in keys:
                check(any(launches[e] for e, v in KERNELS.items()
                          if v[0] == key), f"{key} was not launched on the "
                      f"{label}")
        else:
            recs = rec.records
        runs.append({"wall_s": wall, "stages_ms": timer.ms,
                     "bytes": 8 * sum(1 for _ in proof_words(proof)),
                     "sha256": proof_sha256(proof),
                     "kernel_ms": rec.ms_by_kernel() if rec else None})
        log(f"  {label} prove {'cold' if not i else 'warm'}: {wall:.4f} s; "
            f"proof {runs[-1]['bytes']} bytes (its words as u64s), sha256 "
            f"{runs[-1]['sha256']}")
    peak = torch.cuda.max_memory_allocated()
    log_stages(timer, runs[-1]["wall_s"])
    log(f"  {label}: peak max_memory_allocated {peak / 2**30:.3f} GiB; "
        f"launches {launches}")
    profile = profile_run(lambda: prove(None), warmup=False)
    shas = {r["sha256"] for r in runs}
    check(shas == {want_sha}, f"the {label}'s proofs ({shas}) are not the "
          f"pinned {want_sha}")
    log(f"  every {label} proof's sha256 is the pinned {want_sha}")
    warm = runs[1:]
    kernel_ms = {k: float(np.median([r["kernel_ms"].get(k, 0.0)
                                     for r in warm]))
                 for k in warm[-1]["kernel_ms"]}
    for r in runs:
        del r["kernel_ms"]
    return ({"cold_s": runs[0]["wall_s"],
             "warm_s": [r["wall_s"] for r in warm], "launches": launches,
             "kernel_ms": kernel_ms,
             "cost": path_cost(recs, pow_witness_of(proof)),
             "peak_bytes": peak, "runs": runs, "profile": profile}, proof)


def stark_programs_line(programs, names, compile_s) -> dict:
    """Each compiled program's size and K6 form."""
    from plonky2_tpu_torch.plonk import constraint_program as cp
    from plonky2_tpu_torch.plonk.constraint_program_cuda import k6_form
    out = {}
    for name, prog, sec in zip(names, programs, compile_s):
        lin = cp.linearize(prog)
        form = k6_form(lin.n_slots, max(1, len(prog.bank_sids)))
        out[name] = {"ops": lin.n_ops, "slots": lin.n_slots,
                     "input_rows": lin.n_read, "bank": len(prog.bank_sids),
                     "lanes": form.lanes, "n_shared": form.n_shared,
                     "n_spilled": form.n_spilled, "compile_s": sec}
        log(f"  {name} program: {lin.n_ops} ops, {lin.n_slots} slots, "
            f"{lin.n_read} input rows, bank {len(prog.bank_sids)}; K6 "
            f"{form.lanes} lanes a block, {form.n_shared} slots in shared "
            f"memory, {form.n_spilled} spilled; compiled (traced, "
            f"scheduled, linearized) in {sec:.2f} s")
    return out


def phase_evm(dev) -> dict:
    """The four-table EVM proof (keccak, sponge, logic, memory with live
    CTLs) of EVM_OPS sponge operations under standard_fast_config: the
    port's trace generators, each table's quotient program compiled once,
    prove_all cold and warm (every proof the pinned EVM_PROOF_SHA256),
    the port's verifier on one proof and on a copy with one opened value
    flipped; then the tests' two sponge ops under their small config,
    whose proof must equal the port's CPU proof (EVM_SMALL_PROOF_SHA256,
    which tests/test_torch_evm.py holds equal to the JAX package's).  The
    result keeps the 640-op proof ("proof"), which phase 9i wraps."""
    import copy
    import torch
    from plonky2_tpu_torch.evm import all_stark, workload
    from plonky2_tpu_torch.evm.prover import prove_all
    from plonky2_tpu_torch.evm.verifier import verify_all_proof
    from plonky2_tpu_torch.fri.config import (FriConfig,
                                              FriReductionStrategy)
    from plonky2_tpu_torch.plonk.constraint_program import linearize
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.utils.serialization import proof_sha256
    config = StarkConfig.standard_fast_config()
    t = time.perf_counter()
    ops = workload.sponge_ops(EVM_OPS, seed=SEED)
    traces = all_stark.generate_all_traces(ops)
    gen_s = time.perf_counter() - t
    shapes = [tuple(x.shape) for x in traces]
    check([r.bit_length() - 1 for _, r in shapes] == list(EVM_LOG_ROWS),
          f"EVM table shapes {shapes}")
    log(f"  traces of {EVM_OPS} sponge ops generated on the host in "
        f"{gen_s:.3f} s: {shapes} (keccak, sponge, logic, memory)")
    stark = all_stark.make_all_stark()
    names = [type(x).__name__ for x in stark.starks]
    compile_s = []
    for i in range(len(stark.starks)):
        t = time.perf_counter()
        prog = stark.programs(config)[i]
        linearize(prog)
        compile_s.append(time.perf_counter() - t)
    programs = stark.programs(config)
    prog_line = stark_programs_line(programs, names, compile_s)
    for prog in programs:
        note_program(prog, dev)
    res, proof = prove_stark_path(
        f"EVM proof ({EVM_OPS} ops)",
        lambda timing: prove_all(stark, config, traces, timing=timing),
        STARK_KEYS, EVM_PROOF_SHA256, warm_runs=EARLIER_WARM_RUNS)
    t = time.perf_counter()
    verify_all_proof(stark, proof, config)
    verify_s = time.perf_counter() - t
    log(f"  the port's verifier accepts the proof in {verify_s:.2f} s")
    bad = copy.deepcopy(proof)
    bad.stark_proofs[0].openings.local_values[0][0] ^= np.uint64(1)
    try:
        verify_all_proof(stark, bad, config)
        rejected = None
    except Exception as e:      # the verifiers raise several kinds
        rejected = f"{type(e).__name__}: {e}"
    check(rejected is not None, "the port's verifier accepted a proof "
          "with a flipped opened value")
    log(f"  ... and rejects it with one opened value flipped ({rejected})")
    del bad, traces
    torch.cuda.empty_cache()

    small_config = StarkConfig(
        security_bits=1, num_challenges=2,
        fri_config=FriConfig(
            rate_bits=1, cap_height=2, proof_of_work_bits=8,
            reduction_strategy=FriReductionStrategy.ConstantArityBits(2, 4),
            num_query_rounds=12))
    small = prove_all(stark, small_config, all_stark.generate_all_traces(
        workload.small_sponge_ops()))
    sha = proof_sha256(small)
    check(sha == EVM_SMALL_PROOF_SHA256, f"the card's proof of the tests' "
          f"sponge ops ({sha}) is not the port's CPU proof "
          f"{EVM_SMALL_PROOF_SHA256}")
    log(f"  the tests' two sponge ops under their small config: the card's "
        f"proof equals the port's CPU proof (sha256 {sha}), which the CPU "
        "tests hold equal to the JAX package's")
    res.update(trace_gen_s=gen_s, shapes=shapes, programs=prog_line,
               verify_s=verify_s, proof=proof)
    return res


def phase_fib_stark(dev) -> dict:
    """The Fibonacci STARK at 2^FIB_LOG_N rows, its permutation argument
    included, under standard_fast_config: proved cold and warm (every
    proof the pinned FIB_PROOF_SHA256) and verified once."""
    from plonky2_tpu_torch.models.fibonacci_stark import FibonacciStark
    from plonky2_tpu_torch.plonk.constraint_program import linearize
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.quotient_program import stark_program
    from plonky2_tpu_torch.stark.verifier import verify_stark_proof
    config = StarkConfig.standard_fast_config()
    stark = FibonacciStark(1 << FIB_LOG_N)
    t = time.perf_counter()
    trace = stark.generate_trace(0, 1)
    pis = [0, 1, stark.expected_result(0, 1)]
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    prog = stark_program(stark, config)
    linearize(prog)
    prog_line = stark_programs_line([prog], ["FibonacciStark"],
                                    [time.perf_counter() - t])
    note_program(prog, dev)
    log(f"  trace (4 x 2^{FIB_LOG_N}) and expected result in {gen_s:.3f} s")
    res, proof = prove_stark_path(
        f"Fibonacci STARK (2^{FIB_LOG_N} rows)",
        lambda timing: prove(stark, config, trace, pis, timing=timing),
        STARK_KEYS, FIB_PROOF_SHA256, warm_runs=EARLIER_WARM_RUNS)
    t = time.perf_counter()
    verify_stark_proof(stark, proof, config)
    verify_s = time.perf_counter() - t
    log(f"  the port's verifier accepts the proof in {verify_s:.2f} s")
    res.update(trace_gen_s=gen_s, programs=prog_line, verify_s=verify_s)
    return res


def phase_system_zero(dev) -> dict:
    """System Zero (system_zero/system_zero.py) at its MIN_TRACE_ROWS =
    2^16 rows, 558 columns, under standard_fast_config, nothing cut: the
    trace made on the host, its quotient program compiled (ops, slots,
    K6 form), proved cold and warm (every proof the pinned
    SYSTEM_ZERO_PROOF_SHA256, the port's CPU proof), with its stage times
    (the permutation argument's 44 Z columns in "Z polynomials"), peak
    memory and traced idle share; verified once by the port's verifier,
    which rejects a copy with one opened value flipped."""
    import copy
    from plonky2_tpu_torch.plonk.constraint_program import linearize
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.quotient_program import stark_program
    from plonky2_tpu_torch.stark.verifier import verify_stark_proof
    from plonky2_tpu_torch.system_zero.system_zero import (MIN_TRACE_ROWS,
                                                           SystemZero)
    config = StarkConfig.standard_fast_config()
    stark = SystemZero()
    t = time.perf_counter()
    trace = stark.generate_trace()
    gen_s = time.perf_counter() - t
    check(trace.shape == (stark.COLUMNS, MIN_TRACE_ROWS),
          f"System Zero trace {trace.shape}")
    log(f"  trace {trace.shape} made on the host in {gen_s:.3f} s")
    t = time.perf_counter()
    prog = stark_program(stark, config)
    linearize(prog)
    prog_line = stark_programs_line([prog], ["SystemZero"],
                                    [time.perf_counter() - t])
    note_program(prog, dev)
    res, proof = prove_stark_path(
        f"System Zero (2^{MIN_TRACE_ROWS.bit_length() - 1} rows)",
        lambda timing: prove(stark, config, trace, [0, 0], timing=timing),
        STARK_KEYS, SYSTEM_ZERO_PROOF_SHA256, warm_runs=EARLIER_WARM_RUNS)
    t = time.perf_counter()
    verify_stark_proof(stark, proof, config)
    verify_s = time.perf_counter() - t
    log(f"  the port's verifier accepts the proof in {verify_s:.2f} s")
    bad = copy.deepcopy(proof)
    bad.proof.openings.local_values[0][0] ^= np.uint64(1)
    try:
        verify_stark_proof(stark, bad, config)
        rejected = None
    except Exception as e:      # the verifiers raise several kinds
        rejected = f"{type(e).__name__}: {e}"
    check(rejected is not None, "the port's verifier accepted a System "
          "Zero proof with a flipped opened value")
    log(f"  ... and rejects it with one opened value flipped ({rejected})")
    res.update(trace_gen_s=gen_s, programs=prog_line, verify_s=verify_s)
    return res


def recursion_path(data) -> tuple:
    """The kernels a proof of `data` launches: K2's wide form only where
    the LDE's first Merkle level is wider than its narrow top (2^14
    parents), K7 never (the recursion set's witness is the host's)."""
    wide = data.common.degree_bits() + data.common.config.fri_config \
        .rate_bits - 1 > 14
    return PROVE_PATH if wide else GATE_MIX_PATH


def merge_paths(results) -> dict:
    """Several proofs' numbers as one path of the kernels line: launches,
    kernel ms, costs and walls summed, the highest peak."""
    out = {"launches": {e: sum(r["launches"][e] for r in results)
                        for e in KERNELS},
           "kernel_ms": {}, "cost": {},
           "cold_s": sum(r["cold_s"] for r in results),
           "warm_s": [sum(w) for w in zip(*(r["warm_s"] for r in results))],
           "peak_bytes": max(r["peak_bytes"] for r in results)}
    for r in results:
        for k, v in r["kernel_ms"].items():
            out["kernel_ms"][k] = out["kernel_ms"].get(k, 0.0) + v
        for e, c in r["cost"].items():
            out["cost"][e] = tuple(x + y for x, y in zip(
                out["cost"].get(e, (0, 0, 0)), c))
    return out


def phase_recursion(dev) -> dict:
    """Recursion's chain (models/bench_recursion.py) under
    standard_recursion_config (135 wires, rate 3, cap 4, 28 queries, 16
    bits of proof of work): the no-op proof of 2^RECURSION_INNER_LOG rows
    (device witness), the proof that verifies it and the proof that
    verifies that one (host witness: the plan refuses the recursion set),
    each through ProverSession on the card, cold and warm, verified, every
    proof the pinned RECURSION_PROOF_SHA256 (the port's CPU proofs); each
    link's build seconds, degree, program (ops, slots, K6 form), witness
    seconds, peak and idle share.  The double proof compressed and
    decompressed byte for byte (bench_recursion.report_serialization).
    Then CYCLIC_STEPS links of the cyclic Poseidon hash chain
    (models/cyclic_hash_chain.py) under the JAX test's
    fast_recursion_config (cap height 4, 8 queries, 16 bits of proof of
    work): the cycle's common data, the circuit (its dummy proof made on
    the card), and each link proved and verified, its public inputs the
    iterated host Poseidon and its verifier data the cycle's."""
    import random
    import torch
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.models import bench_recursion as br
    from plonky2_tpu_torch.models.cyclic_hash_chain import (
        build_cyclic_hash_chain, fast_recursion_config, iterate_poseidon,
        prove_link)
    from plonky2_tpu_torch.plonk.recursion import \
        check_cyclic_proof_verifier_data
    from plonky2_tpu_torch.runtime.session import ProverSession
    circ = recursion_circuits()
    config = circ["config"]
    links = {}

    def link(name, data, pw, build_s, device_witness):
        timer = StageTimer()
        sess = ProverSession(data, timing=timer)
        form = k6_form_of(sess)
        log(f"  {name}: 2^{data.common.degree_bits()} rows, built in "
            f"{build_s:.3f} s; quotient program compiled in "
            f"{timer.ms['quotient program']:.3f} ms: {form}")
        res, proof = prove_session(sess, pw, recursion_path(data), name,
                                   RECURSION_PROOF_SHA256[name],
                                   device_witness,
                                   warm_runs=EARLIER_WARM_RUNS)
        res.update(build_s=build_s, degree_bits=data.common.degree_bits(),
                   compile_ms=timer.ms["quotient program"], k6_form=form)
        links[name] = res
        return proof, data.verifier_only, data.common

    inner = link("dummy", circ["dummy"], PartialWitness(), circ["dummy_s"],
                 True)
    single, pt, vt = circ["single"]
    middle = link("single", single, br.recursion_witness(pt, vt, inner),
                  circ["single_s"], False)
    t = time.perf_counter()
    double, pt, vt = br.recursion_circuit(single.common, config)
    torch.cuda.synchronize()
    outer = link("double", double, br.recursion_witness(pt, vt, middle),
                 time.perf_counter() - t, False)

    sizes = br.report_serialization(*outer)
    log(f"  double proof: {sizes['proof_bytes']} bytes, compressed "
        f"{sizes['compressed_bytes']} bytes in "
        f"{sizes['compress_seconds']:.3f} s; decompressed in "
        f"{sizes['decompress_seconds']:.3f} s, byte for byte the proof")
    del circ, single, double, inner, middle, outer
    torch.cuda.empty_cache()

    cyc_timer = StageTimer()
    t = time.perf_counter()
    chain = build_cyclic_hash_chain(fast_recursion_config(),
                                    rng=random.Random(0), timing=cyc_timer)
    torch.cuda.synchronize()
    cyc_build_s = time.perf_counter() - t
    log(f"  cyclic hash chain: common data (three builds) in "
        f"{cyc_timer.ms['common data'] / 1e3:.3f} s, 2^"
        f"{chain.common_data.degree_bits()} rows; the circuit, its dummy "
        f"proof included, in "
        f"{cyc_timer.ms['dummy proof and build'] / 1e3:.3f} s; "
        f"{cyc_build_s:.3f} s in all")
    steps, previous = [], None
    for i in range(CYCLIC_STEPS):
        t = time.perf_counter()
        previous = prove_link(chain, previous, CYCLIC_INITIAL,
                              rng=random.Random(i))
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t
        t = time.perf_counter()
        chain.data.verify(previous)
        check_cyclic_proof_verifier_data(previous, chain.data.verifier_only,
                                         chain.data.common)
        verify_s = time.perf_counter() - t
        pis = [int(x) for x in previous.public_inputs]
        check(pis[0:4] == CYCLIC_INITIAL and pis[8] == i + 1
              and pis[4:8] == iterate_poseidon(CYCLIC_INITIAL, i + 1),
              f"cyclic link {i + 1}'s public inputs are not the chain")
        steps.append({"prove_s": prove_s, "verify_s": verify_s})
        log(f"  cyclic link {i + 1}: proved in {prove_s:.3f} s "
            f"({'with its dummy base proof' if not i else 'host witness'}"
            f"), verified in {verify_s:.3f} s; tip = Poseidon^{i + 1} of "
            "the initial hash, verifier data the cycle's")
    res = merge_paths(list(links.values()))
    res.update(links={k: {f: v[f] for f in (
        "cold_s", "warm_s", "build_s", "degree_bits", "compile_ms",
        "k6_form", "peak_bytes", "profile", "runs")}
        for k, v in links.items()},
        double_bytes=sizes["proof_bytes"],
        double_compressed_bytes=sizes["compressed_bytes"],
        compress_s=sizes["compress_seconds"],
        decompress_s=sizes["decompress_seconds"],
        cyclic={"build_s": cyc_build_s, "stages_ms": cyc_timer.ms,
                "degree_bits": chain.data.common.degree_bits(),
                "steps": steps})
    return res


@functools.lru_cache(maxsize=1)
def wrapper_programs() -> dict:
    """The quotient programs of phase 9i's wrappers, from their common
    data (nothing committed): the Fibonacci wrapper's and the EVM memory
    table's at EVM_LOG_ROWS (the four EVM wrappers' gate sets are one)."""
    from plonky2_tpu_torch.evm import all_stark
    from plonky2_tpu_torch.evm.recursive_verifier import wrapper_builder
    from plonky2_tpu_torch.models.fibonacci_stark import FibonacciStark
    from plonky2_tpu_torch.models.stark_wrapper import stark_wrapper_builder
    from plonky2_tpu_torch.plonk.quotient_program import \
        build_quotient_program
    from plonky2_tpu_torch.stark.config import StarkConfig
    config = StarkConfig.standard_fast_config()
    fib, _ = stark_wrapper_builder(FibonacciStark(1 << FIB_LOG_N), config,
                                   FIB_LOG_N)
    mem = all_stark.MEMORY
    evm = wrapper_builder(all_stark.MemoryStark(),
                          all_stark.all_cross_table_lookups(), mem,
                          EVM_LOG_ROWS[mem], config)[0]
    return {"Fibonacci wrapper": build_quotient_program(fib.build_common()),
            "EVM wrapper": build_quotient_program(evm.build_common())}


def gate_set_program():
    """Phase 9k's quotient program (models/gate_set.py at its sizes)."""
    from plonky2_tpu_torch.models.gate_set import build_gate_set_circuit
    from plonky2_tpu_torch.plonk.quotient_program import \
        build_quotient_program
    return build_quotient_program(build_gate_set_circuit(build=False)[0])


def ecdsa_program():
    """Phase 9l's quotient program (models/ecdsa_verify.py's circuit at
    full width, from its common data: nothing committed)."""
    from plonky2_tpu_torch.models.ecdsa_verify import ecdsa_builder
    from plonky2_tpu_torch.plonk.quotient_program import \
        build_quotient_program
    return build_quotient_program(ecdsa_builder()[0].build_common())


def arithmetic_program():
    """Phase 9m's quotient program (the range-checked arithmetic table's
    eval and its 96 permutation pairs)."""
    from plonky2_tpu_torch.evm.arithmetic import ArithmeticStark
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.quotient_program import build_stark_program
    return build_stark_program(ArithmeticStark(range_check=True),
                               StarkConfig.standard_fast_config())


def refused(fn, kinds, match: str) -> str:
    """The error that `fn()` raises, as text: it must be of `kinds` and
    its message must hold `match`; any other error goes up.  None if
    fn() returns."""
    try:
        fn()
    except kinds as e:
        why = f"{type(e).__name__}: {e}"
        check(match in str(e), f"refused for another reason: {why}")
        return why
    return None


def new_session(data) -> tuple:
    """A ProverSession of `data` on the card and its quotient program's
    compile milliseconds."""
    from plonky2_tpu_torch.runtime.session import ProverSession
    timer = StageTimer()
    sess = ProverSession(data, timing=timer)
    return sess, timer.ms["quotient program"]


def wrap_session(label, sess, compile_ms, pw, want_sha, build_s,
                 want_pis=None, trace=True, prove=None,
                 warm_runs=EARLIER_WARM_RUNS):
    """A circuit of phases 9i-9l through its ProverSession `sess` on the
    card (its quotient program compiled in `compile_ms`): the device
    witness plan refused for `pw` (the host engine runs), one cold and
    `warm_runs` warm proofs of `pw`, or of `prove(rng, timing)`
    where an entry point proves in `sess` (prove_session), the last of
    them traced for the idle share where `trace`; returns (the path's
    numbers with the circuit's rows and build
    seconds, the proof)."""
    from plonky2_tpu_torch.iop import device_witness as dw
    data = sess.data
    check(dw.build_plan(data.prover_only, data.common, pw, sess.device)
          is None, f"the device witness plan took the {label}")
    form = k6_form_of(sess)
    log(f"  {label}: 2^{data.common.degree_bits()} rows, built in "
        f"{build_s:.3f} s; quotient program compiled in "
        f"{compile_ms:.3f} ms: {form}")
    res, proof = prove_session(sess, pw, recursion_path(data), label,
                               want_sha, False, want_pis=want_pis,
                               warm_runs=warm_runs, trace=trace,
                               prove=prove)
    res.update(build_s=build_s, degree_bits=data.common.degree_bits(),
               compile_ms=compile_ms, k6_form=form)
    return res, proof


def phase_wrap_fib(dev) -> dict:
    """Phase 9i (a): phase 9f's Fibonacci STARK proof at 2^FIB_LOG_N rows
    (proved again here, its sha256 FIB_PROOF_SHA256) in
    models/stark_wrapper.py's circuit under standard_recursion_config,
    built on the card, proved through ProverSession (host witness), cold
    and warm, verified and pinned (WRAP_FIB_PROOF_SHA256, the port's CPU
    proof), its public inputs the STARK's; a copy of the STARK proof with
    one opened value changed is refused by the witness (a partition set
    twice with different values)."""
    import copy
    import torch
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.models.fibonacci_stark import FibonacciStark
    from plonky2_tpu_torch.models.stark_wrapper import stark_wrapper_builder
    from plonky2_tpu_torch.stark import recursive_verifier as srv
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.utils.serialization import proof_sha256
    config = StarkConfig.standard_fast_config()
    stark = FibonacciStark(1 << FIB_LOG_N)
    pis = [0, 1, stark.expected_result(0, 1)]
    stark_proof = prove(stark, config, stark.generate_trace(0, 1), pis)
    check(proof_sha256(stark_proof) == FIB_PROOF_SHA256,
          "the Fibonacci STARK proof is not phase 9f's")
    t = time.perf_counter()
    b, pt = stark_wrapper_builder(stark, config, FIB_LOG_N)
    data = b.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    pw = PartialWitness()
    srv.set_stark_proof_with_pis_target(pw, pt, stark_proof)
    sess, compile_ms = new_session(data)
    fib, _ = wrap_session("Fibonacci wrapper", sess, compile_ms, pw,
                          WRAP_FIB_PROOF_SHA256, build_s, want_pis=pis)
    bad_proof = copy.deepcopy(stark_proof)
    bad_proof.proof.openings.local_values[0][0] ^= np.uint64(1)
    bad = PartialWitness()
    srv.set_stark_proof_with_pis_target(bad, pt, bad_proof)
    why = refused(lambda: sess.verify(sess.prove(bad)), ValueError,
                  "set twice with different values")
    check(why is not None, "the Fibonacci wrapper accepted a STARK proof "
          "with a changed opened value")
    log(f"  ... and refuses a STARK proof with one opened value changed "
        f"({why[:160]})")
    return fib


def phase_wrap_evm(dev, evm_proof) -> dict:
    """Phase 9i (b): phase 9e's EVM proof of EVM_OPS sponge ops wrapped
    table by table under standard_recursion_config through
    evm/recursive_verifier.py's entry points: the transcript replayed on
    the host (replay_challenger_states); each table's wrapper built on the
    card with its session (recursive_stark_circuit) and proved in it
    through wrap_table_proof (host witness), once (its kernels timed in
    that run), verified and pinned (EVM_WRAPPER_PROOF_SHA256), the keccak
    wrapper's proof, the largest, traced for the idle share; then
    wrap_all_proof over those circuits, which proves each table's wrapper
    again, and the aggregate check of its proofs
    (verify_recursive_all_proof).  Each wrapper's decoded public inputs
    are the transcript's states, the CTL challenges, the table proof's
    ctl_zs_last and trace cap; the memory wrapper refuses wrong CTL
    challenges in its witness."""
    import hashlib
    import random
    import torch
    from plonky2_tpu_torch.evm import all_stark
    from plonky2_tpu_torch.evm import recursive_verifier as erv
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.utils.serialization import serialize_proof
    config = StarkConfig.standard_fast_config()
    astark = all_stark.make_all_stark()
    t = time.perf_counter()
    ctl_challenges, states = erv.replay_challenger_states(astark, evm_proof,
                                                          config)
    replay_s = time.perf_counter() - t
    log(f"  EVM transcript replayed on the host in {replay_s:.3f} s")

    def public_inputs_check(name, i, proof):
        tproof = evm_proof.stark_proofs[i]
        pi = erv.PublicInputs.from_vec(proof.public_inputs, config)
        check(pi.ctl_challenges == ctl_challenges
              and pi.challenger_state_before == states[i][0]
              and pi.challenger_state_after == states[i][1]
              and pi.ctl_zs_last == [int(v) for v in
                                     tproof.openings.ctl_zs_last]
              and pi.trace_cap == [[int(x) for x in h]
                                   for h in tproof.trace_cap.digests],
              f"the {name} wrapper's public inputs are not the proof's")

    tables, circuits = {}, {}
    for i, (tstark, tproof, db) in enumerate(zip(
            astark.starks, evm_proof.stark_proofs, evm_proof.degree_bits)):
        name = type(tstark).__name__
        timer = StageTimer()
        t = time.perf_counter()
        wc = erv.recursive_stark_circuit(tstark, astark.cross_table_lookups,
                                         i, db, config, timing=timer)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        compile_ms = timer.ms["quotient program"]

        def prove(rng, timing=None, wc=wc, tproof=tproof, i=i):
            return erv.wrap_table_proof(wc, tproof, states[i][0],
                                        ctl_challenges, rng=rng,
                                        timing=timing)
        res, proof = wrap_session(
            f"{name} wrapper (2^{db}-row table)", wc.session, compile_ms,
            erv.table_witness(wc, tproof, states[i][0], ctl_challenges),
            EVM_WRAPPER_PROOF_SHA256[name], build_s, trace=not i,
            prove=prove, warm_runs=0)
        public_inputs_check(name, i, proof)
        tables[name] = res
        circuits[i] = wc
    check(len({tuple(g.id() for g in wc.data.common.gates)
               for wc in circuits.values()}) == 1,
          "the four EVM wrappers' gate sets differ")

    torch.cuda.synchronize()
    t = time.perf_counter()
    wrapped, out = erv.wrap_all_proof(astark, evm_proof, config,
                                      circuits=circuits,
                                      rng=random.Random(0))
    torch.cuda.synchronize()
    all_s = time.perf_counter() - t
    check(all(wc is circuits[i] for i, wc in enumerate(out)),
          "wrap_all_proof built circuits of its own")
    shas = [hashlib.sha256(serialize_proof(p)).hexdigest() for p in wrapped]
    first = type(astark.starks[0]).__name__
    check(shas[0] == EVM_WRAPPER_PROOF_SHA256[first],
          f"wrap_all_proof's {first} proof ({shas[0]}) is not the pinned "
          f"{EVM_WRAPPER_PROOF_SHA256[first]}")
    for i, proof in enumerate(wrapped):
        public_inputs_check(type(astark.starks[i]).__name__, i, proof)
    log(f"  wrap_all_proof over the four circuits (one random.Random(0) "
        f"for the four witnesses): {all_s:.3f} s; proofs' sha256 {shas}")
    t = time.perf_counter()
    erv.verify_recursive_all_proof(wrapped, out, astark.cross_table_lookups,
                                   config)
    aggregate_s = time.perf_counter() - t
    log(f"  the aggregate check (one CTL challenge set, the chained "
        f"transcript states, the CTL products) and the four wrapper "
        f"proofs' verifier: {aggregate_s:.3f} s")
    mem = all_stark.MEMORY
    bad = type(ctl_challenges)(challenges=[
        type(c)(beta=(c.beta + 1) % P, gamma=c.gamma)
        for c in ctl_challenges.challenges])
    why = refused(lambda: erv.wrap_table_proof(
        circuits[mem], evm_proof.stark_proofs[mem], states[mem][0], bad,
        rng=random.Random(0)), ValueError, "set twice with different values")
    check(why is not None, "the memory wrapper accepted wrong CTL "
          "challenges")
    log(f"  ... the memory wrapper refuses wrong CTL challenges "
        f"({why[:160]})")
    setup_s = sum(r["build_s"] for r in tables.values()) + sum(
        r["runs"][0]["stages_ms"].get("witness", 0.0) / 1e3
        for r in tables.values())
    log(f"  the four wrappers' builds (sessions included) and cold host "
        f"witnesses: {setup_s:.3f} s")
    res = merge_paths(list(tables.values()))
    res.update(tables=tables, replay_s=replay_s, aggregate_s=aggregate_s,
               wrap_all_s=all_s, evm_setup_s=setup_s)
    return res


def phase_tree(dev) -> dict:
    """Tree recursion (plonk/tree_recursion.py), tests/test_tree_
    recursion.py:24-61's tree (models/recursion_tree.py) at depth 2 under
    standard_recursion_config:
    the inner Fibonacci circuit and its proof, the shared common data
    (common_data_for_recursion(config, 5, 2)), the leaf circuit and four
    leaf proofs over the inner proof, the node circuit and two node
    proofs over pairs of leaves, and the root over the nodes, each through
    ProverSession on the card (the first of each circuit cold), verified,
    checked by check_tree_proof_verifier_data and pinned
    (TREE_PROOF_SHA256); the root proved a second time repeats its
    proof."""
    import hashlib
    import random
    import torch
    from plonky2_tpu_torch.iop import device_witness as dw
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.models.recursion_tree import (build_tree_circuits,
                                                         tree_witnesses)
    from plonky2_tpu_torch.plonk import tree_recursion as tr
    from plonky2_tpu_torch.runtime.session import ProverSession
    from plonky2_tpu_torch.utils.serialization import serialize_proof
    builds = {}

    def timed_build(name, make):
        t = time.perf_counter()
        out = make()
        torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t
        return out

    tree = build_tree_circuits(stage=timed_build)
    inner, inner_pw, common = tree["inner"], tree["inner_pw"], tree["common"]
    leaf, node = tree["leaf"], tree["node"]
    log(f"  built on the card: the inner circuit (2^"
        f"{inner.common.degree_bits()} rows) in {builds['inner']:.3f} s, "
        f"the common data (three builds, nothing committed) in "
        f"{builds['common data']:.3f} s, the leaf and node circuits (2^"
        f"{common.degree_bits()} rows) in {builds['leaf']:.3f} and "
        f"{builds['node']:.3f} s")
    sessions = {}
    for name, data in (("inner", inner), ("leaf", leaf), ("node", node)):
        timer = StageTimer()
        sessions[name] = ProverSession(data, timing=timer)
        note_program(sessions[name].prover_data.program, dev)
        log(f"  {name} session: quotient program compiled in "
            f"{timer.ms['quotient program']:.3f} ms: "
            f"{k6_form_of(sessions[name])}")
    inner_plan = dw.build_plan(inner.prover_only, inner.common, inner_pw,
                               dev) is not None
    check(dw.build_plan(leaf.prover_only, leaf.common, PartialWitness(),
                        dev) is None, "the witness plan took the leaf")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    runs = []

    def run(name, data, pw, seed, want):
        timer = StageTimer()
        t = time.perf_counter()
        proof = sessions[name].prove(pw, rng=random.Random(seed),
                                     timing=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        t = time.perf_counter()
        data.verify(proof)
        if name != "inner":
            tr.check_tree_proof_verifier_data(proof, data.verifier_only,
                                              common)
        verify_s = time.perf_counter() - t
        blob = serialize_proof(proof)
        sha = hashlib.sha256(blob).hexdigest()
        wit = timer.ms.get("witness", timer.ms.get("device witness", 0.0))
        first = not any(r["circuit"] == name for r in runs)
        runs.append({"circuit": name, "seed": seed, "wall_s": wall,
                     "witness_s": wit / 1e3, "verify_s": verify_s,
                     "bytes": len(blob), "sha256": sha, "cold": first,
                     "stages_ms": timer.ms})
        log(f"  {name} (random.Random({seed})) prove "
            f"{'cold' if first else 'warm'}: {wall:.4f} s (witness "
            f"{wit / 1e3:.4f} s); verify and verifier data {verify_s:.3f} s;"
            f" proof {len(blob)} bytes, sha256 {sha}")
        check(sha == want, f"the {name} proof ({sha}) is not the pinned "
              f"{want}")
        return proof

    want = TREE_PROOF_SHA256
    inner_proof = run("inner", inner, inner_pw, 0, want["inner"])
    leaf_pw, node_pw = tree_witnesses(tree, inner_proof)
    leaves = [run("leaf", leaf, leaf_pw(), i, want["leaf"][i])
              for i in range(4)]
    nodes = [run("node", node, node_pw(*leaves[2 * j:2 * j + 2]), 4 + j,
                 want["node"][j]) for j in range(2)]
    root_pw = node_pw(*nodes)
    root = run("node", node, root_pw, 6, want["root"])
    launches = read_launch_counts()
    for entry in recursion_path(node):
        check(launches[entry] > 0, f"{entry} was not launched on the tree")
    peak = torch.cuda.max_memory_allocated()
    with KernelRecorder() as rec:
        again = run("node", node, root_pw, 6, want["root"])
    check(serialize_proof(again) == serialize_proof(root),
          "the root proved again is another proof")
    log(f"  the root proved again repeats its proof; peak "
        f"max_memory_allocated {peak / 2**30:.3f} GiB; launches {launches}"
        f"; the inner proof's witness from the "
        f"{'device plan' if inner_plan else 'host engine'}")
    profile = profile_run(lambda: sessions["node"].prove(
        root_pw, rng=random.Random(6)), warmup=False)
    cold = [r for r in runs if r["cold"]]
    warm = [r for r in runs if not r["cold"]]
    return {"launches": launches, "kernel_ms": rec.ms_by_kernel(),
            "cost": path_cost(rec.records, pow_witness_of(again)),
            "cold_s": sum(r["wall_s"] for r in cold),
            "warm_s": [r["wall_s"] for r in warm], "peak_bytes": peak,
            "profile": profile, "build_s": builds,
            "degree_bits": common.degree_bits(), "runs": runs}


def phase_gate_set(dev) -> dict:
    """The U32, comparison and permutation gate set (gates/u32_gates.py,
    assert_le.py, switch.py, insertion.py; gadgets/u32.py,
    permutation.py) in models/gate_set.py's circuit of 2^LOG_N rows under
    standard_ecc_config, built on the card, proved cold and warm through
    ProverSession (host witness), verified, every proof the pinned
    GATE_SET_PROOF_SHA256 (the port's CPU proof); then a non-permutation,
    which the routing refuses in the witness."""
    import random
    import torch
    from plonky2_tpu_torch.models import gate_set
    from plonky2_tpu_torch.runtime.session import ProverSession
    t = time.perf_counter()
    data, pw = gate_set.build_gate_set_circuit()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    check(data.common.degree_bits() == gate_set.LOG_N,
          f"the gate set has 2^{data.common.degree_bits()} rows")
    gates = [g.id().split(" ")[0] for g in data.common.gates]
    log(f"  {len(gates)} gate types: {gates}")
    sess, compile_ms = new_session(data)
    res, _ = wrap_session("gate set", sess, compile_ms, pw,
                          GATE_SET_PROOF_SHA256, build_s)
    bad, bad_pw = gate_set.build_non_permutation_circuit()
    why = refused(lambda: ProverSession(bad).prove(bad_pw,
                                                   rng=random.Random(0)),
                  ValueError, "permutations of one another")
    check(why is not None, "a non-permutation was not refused")
    log(f"  ... and a non-permutation is refused ({why[:160]})")
    res.update(gates=gates)
    return res


def phase_ecdsa(dev) -> dict:
    """secp256k1 ECDSA verification in a circuit (ecdsa/gadgets.py over
    gadgets/{biguint,nonnative,u32}.py): models/ecdsa_verify.py's circuit
    at full width under standard_ecc_config, its gates placed and built
    on the card (build()'s stages timed), the gate count and the rows
    pinned, the signature checked natively (ecdsa/curve.py); proved cold
    and warm through ProverSession (host witness), verified, every proof
    the pinned ECDSA_PROOF_SHA256; a copy of the proof with one opened
    wire changed refused by the verifier."""
    import collections
    import copy
    import torch
    from plonky2_tpu_torch.ecdsa import curve
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.models import ecdsa_verify
    from plonky2_tpu_torch.plonk.verifier import ProofVerificationError
    t = time.perf_counter()
    b, inputs = ecdsa_verify.ecdsa_builder()
    place_s = time.perf_counter() - t
    n_gates = b.num_gates()
    check(n_gates == ecdsa_verify.GATES, f"the ECDSA circuit placed "
          f"{n_gates} gates, not {ecdsa_verify.GATES}")
    gates = dict(collections.Counter(type(i.gate).__name__
                                     for i in b.gate_instances))
    check(curve.verify_message(inputs.msg, inputs.sig, inputs.pk),
          "ecdsa/curve.py:verify_message refuses the signature")
    log(f"  {n_gates} gates placed on the host in {place_s:.3f} s: "
        f"{gates}; the signature verifies natively")
    timer = StageTimer()
    t = time.perf_counter()
    data = b.build(timing=timer)
    torch.cuda.synchronize()
    build_s = place_s + time.perf_counter() - t
    check(data.common.degree_bits() == ecdsa_verify.LOG_N,
          f"the ECDSA circuit has 2^{data.common.degree_bits()} rows")
    log("  build() stages (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in timer.ms.items()))
    sess, compile_ms = new_session(data)
    res, proof = wrap_session("ECDSA circuit", sess, compile_ms,
                              PartialWitness(), ECDSA_PROOF_SHA256, build_s)
    bad = copy.deepcopy(proof)
    bad.proof.openings.wires[0, 0] = (int(bad.proof.openings.wires[0, 0])
                                      + 1) % P
    why = refused(lambda: sess.verify(bad), ProofVerificationError,
                  "vanishing polynomial check failed")
    check(why is not None, "the verifier accepted an ECDSA proof with an "
          "opened wire changed")
    log(f"  ... and refuses a copy with one opened wire changed ({why})")
    res.update(gates=gates, n_gates=n_gates, place_s=place_s,
               build_stages_ms=timer.ms)
    return res


def arithmetic_outputs_ok(trace, ops) -> bool:
    """Each op's output in the trace (its result, residue, quotient or
    comparison bit) is its Python-int Operation.result."""
    from plonky2_tpu_torch.evm import arithmetic as ar
    rows = np.ascontiguousarray(trace[:ar.NUM_ARITH_COLUMNS].T)
    shifts = [ar.LIMB_BITS * i for i in range(ar.N_LIMBS)]

    def value(row, cols):
        return sum(int(v) << k for v, k in zip(rows[row, cols.start:
                                                    cols.stop], shifts))
    j = 0
    for op in ops:
        if op.op in ("lt", "gt"):
            got = int(rows[j, ar.CMP_OUTPUT])
        elif op.op == "div":
            got = value(j, ar.DIV_OUTPUT)
        elif op.op in ar.MODULAR_OPS:
            got = value(j, ar.MODULAR_OUTPUT)
        else:
            got = value(j, ar.GENERAL_INPUT_2)
        if got != op.result:
            return False
        j += op.num_rows()
    return True


def forged_limb_trace(trace, ops) -> tuple:
    """(row, a copy of the range-checked `trace`) with input0 of an add
    written non-canonically: its low limb plus 2^16, the next limb less
    one, the same 256-bit value (tests/test_evm_range_check.py:
    _rc_forged_traces), and the masked and permuted lookup columns of
    that limb recomputed, as a cheating prover would.  The add's carries
    still hold; only the 16-bit range check can refuse it."""
    from plonky2_tpu_torch.evm import arithmetic as ar
    from plonky2_tpu_torch.system_zero.lookup import permuted_cols
    j = 0
    for op in ops:
        a, b = ar.to_limbs(op.input0), ar.to_limbs(op.input1)
        if op.op == "add" and a[0] + b[0] <= ar.MASK and a[1]:
            break
        j += op.num_rows()
    else:
        raise ValueError("no add without a carry from its low limb")
    bad = trace.copy()
    c0 = ar.GENERAL_INPUT_0.start
    bad[c0, j] += np.uint64(ar.BASE)
    bad[c0 + 1, j] -= np.uint64(1)
    filt = bad[ar.CTL_OPS].sum(axis=0)
    for i in (0, 1):
        masked = np.where(filt != 0, bad[c0 + i], 0).astype(np.uint64)
        bad[ar.rc_masked_col(i)] = masked
        pi, pt = permuted_cols(masked, bad[ar.RANGE_COUNTER])
        bad[ar.rc_perm_input_col(i)], bad[ar.rc_perm_table_col(i)] = pi, pt
    return j, bad


def constraint_count(stark) -> int:
    """How many constraints `stark`'s eval yields."""
    from plonky2_tpu_torch.plonk.algebra import ScalarBase
    from plonky2_tpu_torch.stark.stark import StarkEvaluationVars

    class Counter:
        n = 0

        def constraint(self, c):
            self.n += 1
        constraint_transition = constraint_first_row = \
            constraint_last_row = constraint

    count = Counter()
    zeros = [0] * stark.COLUMNS
    stark.eval(ScalarBase(), StarkEvaluationVars(zeros, zeros, []), count)
    return count.n


def phase_arithmetic(dev) -> dict:
    """The EVM's 256-bit arithmetic table with its 16-bit range check
    (evm/arithmetic.py, ArithmeticStark(range_check=True): 237 columns,
    48 lookups) on evm/workload.py:arithmetic_ops() under
    standard_fast_config: the trace made on the host (2^16 rows) and
    each op's output held against its Python int, the quotient program
    compiled (ops, slots, K6 form), proved cold and warm (every proof the
    pinned ARITHMETIC_PROOF_SHA256, the port's CPU proof) and verified;
    then two tampered traces: a mul row's product with its low limb
    flipped, whose proof the verifier refuses, and an input written with
    a limb of 2^16 or more (forged_limb_trace), which breaks only the
    range check's constraints (stark/testing.py:
    trace_constraint_violations)."""
    import torch
    from plonky2_tpu_torch.evm import arithmetic as ar
    from plonky2_tpu_torch.evm.workload import arithmetic_ops
    from plonky2_tpu_torch.plonk.constraint_program import linearize
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.quotient_program import stark_program
    from plonky2_tpu_torch.stark.testing import trace_constraint_violations
    from plonky2_tpu_torch.stark.verifier import (StarkVerificationError,
                                                  verify_stark_proof)
    config = StarkConfig.standard_fast_config()
    stark = ar.ArithmeticStark(range_check=True)
    ops = arithmetic_ops()
    t = time.perf_counter()
    trace = stark.generate_trace(ops)
    gen_s = time.perf_counter() - t
    used = sum(op.num_rows() for op in ops)
    check(trace.shape == (ar.NUM_ARITH_RC_COLUMNS, ar.RC_MIN_ROWS)
          and 60000 <= used < ar.RC_MIN_ROWS,
          f"arithmetic trace {trace.shape}, {used} rows used")
    check(arithmetic_outputs_ok(trace, ops), "an op's output in the trace "
          "is not its Python-int result")
    log(f"  {len(ops)} ops in {used} of {trace.shape[1]} rows: trace "
        f"{trace.shape} made on the host in {gen_s:.3f} s; every output "
        "is its Python-int result")
    t = time.perf_counter()
    prog = stark_program(stark, config)
    linearize(prog)
    prog_line = stark_programs_line([prog], ["ArithmeticStark"],
                                    [time.perf_counter() - t])
    note_program(prog, dev)
    res, proof = prove_stark_path(
        f"arithmetic table (2^{ar.LIMB_BITS} rows, range-checked)",
        lambda timing: prove(stark, config, trace, [], timing=timing),
        STARK_KEYS, ARITHMETIC_PROOF_SHA256, warm_runs=EARLIER_WARM_RUNS)
    t = time.perf_counter()
    verify_stark_proof(stark, proof, config)
    verify_s = time.perf_counter() - t
    log(f"  the port's verifier accepts the proof in {verify_s:.2f} s")
    del proof
    torch.cuda.empty_cache()

    mul_row = next(j for j, op in zip(np.cumsum(
        [0] + [o.num_rows() for o in ops]), ops) if op.op == "mul")
    bad = trace.copy()
    bad[ar.GENERAL_INPUT_2.start, mul_row] ^= np.uint64(1)
    why = refused(lambda: verify_stark_proof(
        stark, prove(stark, config, bad, []), config),
        StarkVerificationError, "quotient mismatch")
    check(why is not None, "a proof of a wrong product was accepted")
    log(f"  a wrong product (row {mul_row}) is refused: {why[:160]}")

    row, bad = forged_limb_trace(trace, ops)
    t = time.perf_counter()
    violations = trace_constraint_violations(stark, bad)
    scan_s = time.perf_counter() - t
    first_rc = constraint_count(ar.ArithmeticStark())
    check(violations and min(violations) >= first_rc,
          f"a limb of 2^16 gave the violations {violations} (the range "
          f"check's constraints start at {first_rc})")
    log(f"  input0 of the add on row {row} written with a limb of 2^16 or "
        f"more (the same 256-bit value, its lookup columns recomputed) "
        f"breaks the range check's constraints {violations} and no other "
        f"({scan_s:.2f} s on the host)")
    res.update(trace_gen_s=gen_s, programs=prog_line, verify_s=verify_s,
               n_ops=len(ops), rows_used=used)
    return res


def cpu_table_program():
    """Phase 9n's CPU table program (the block kernel's CpuStark): its
    eval and the checks of its twelve CTL lookups (24 Z columns at two
    challenges), for phase 3."""
    from plonky2_tpu_torch.evm import all_stark
    from plonky2_tpu_torch.evm.block import block_kernel
    from plonky2_tpu_torch.evm.cpu import CpuStark
    from plonky2_tpu_torch.evm.cross_table_lookup import ctl_zs_layout
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.quotient_program import build_stark_program
    config = StarkConfig.standard_fast_config()
    return build_stark_program(
        CpuStark(block_kernel(in_kernel_ecrecover=True)), config,
        ctl_zs_layout(all_stark.all_cross_table_lookups_with_cpu(),
                      all_stark.CPU_TABLES["cpu"], config.num_challenges))


def phase_block(dev) -> dict:
    """The zkEVM's six-table block proof of one signed transfer
    (evm/workload.py:transfer_inputs): the block kernel assembled (its
    code and code hash the JAX package's), the kernel executed on the host
    with the sender recovered in the kernel (evm/block.py:
    generate_block_traces, range check on; each trace the JAX package's),
    the state root after the block the hand-built trie's; the six quotient
    programs compiled (ops, slots, K6 form); proved cold and warm through
    prove_block_traces (every proof the pinned BLOCK_PROOF_SHA256); the
    port's verifier accepts the proof and refuses it with one opened value
    of the CPU table flipped."""
    import copy
    import dataclasses
    import hashlib
    import torch
    from plonky2_tpu_torch.evm import all_stark
    from plonky2_tpu_torch.evm.block import (block_kernel,
                                             generate_block_traces,
                                             prove_block_traces)
    from plonky2_tpu_torch.evm.verifier import (EvmVerificationError,
                                                 verify_all_proof)
    from plonky2_tpu_torch.evm.workload import transfer_inputs
    from plonky2_tpu_torch.plonk.constraint_program import linearize
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.verifier import StarkVerificationError
    from plonky2_tpu_torch.fri.verifier import FriVerificationError
    config = StarkConfig.standard_fast_config()
    t = time.perf_counter()
    kernel = block_kernel(in_kernel_ecrecover=True)
    asm_s = time.perf_counter() - t
    code_sha = hashlib.sha256(bytes(kernel.code)).hexdigest()
    code_hash = b"".join(int(x).to_bytes(4, "little")
                         for x in kernel.code_hash).hex()
    check((code_sha, code_hash) == (BLOCK_KERNEL_SHA256, BLOCK_CODE_HASH),
          f"the block kernel ({code_sha}, code hash {code_hash}) is not the "
          "JAX package's")
    log(f"  block kernel: {len(kernel.code)} code bytes assembled in "
        f"{asm_s:.3f} s, sha256 {code_sha} and code hash {code_hash}, the "
        "JAX package's")
    inputs, after = transfer_inputs()
    t = time.perf_counter()
    traces, public_values, kernel = generate_block_traces(
        inputs, range_check=True, in_kernel_ecrecover=True)
    gen_s = time.perf_counter() - t
    got = tuple((tr.shape[0], tr.shape[1], hashlib.sha256(
        np.ascontiguousarray(tr, dtype=np.uint64).tobytes()).hexdigest())
        for tr in traces)
    shapes = [tuple(tr.shape) for tr in traces]
    log(f"  six traces generated on the host in {gen_s:.3f} s: {shapes} "
        "(cpu, keccak, sponge, logic, memory, arithmetic)")
    check(got == BLOCK_TRACES, f"the block's traces {got} are not the "
          "JAX package's")
    log("  every trace's sha256 is the JAX package's")
    check(public_values.trie_roots_after.state_root == after.calc_hash(),
          "the state root after the block is not the hand-built trie's")
    root = public_values.trie_roots_after.state_root
    log(f"  the state root after the block {root:#x} is the hand-built "
        "trie's")
    stark = all_stark.make_all_stark_with_cpu(kernel, range_check=True)
    names = [type(x).__name__ for x in stark.starks]
    compile_s = []
    for i in range(len(stark.starks)):
        t = time.perf_counter()
        prog = stark.programs(config)[i]
        linearize(prog)
        compile_s.append(time.perf_counter() - t)
    programs = stark.programs(config)
    prog_line = stark_programs_line(programs, names, compile_s)
    for prog in programs:
        note_program(prog, dev)

    def prove(timing):
        proof, _ = prove_block_traces(traces, public_values, kernel, config,
                                      timing=timing, all_stark=stark)
        return dataclasses.replace(proof, public_values=None)

    res, proof = prove_stark_path(
        "block proof (one signed transfer, six tables)", prove, STARK_KEYS,
        BLOCK_PROOF_SHA256, warm_runs=EARLIER_WARM_RUNS)
    t = time.perf_counter()
    verify_all_proof(stark, proof, config)
    verify_s = time.perf_counter() - t
    log(f"  the port's verifier accepts the proof in {verify_s:.2f} s")
    bad = copy.deepcopy(proof)
    bad.stark_proofs[0].openings.local_values[0][0] ^= np.uint64(1)
    t = time.perf_counter()
    why = refused(lambda: verify_all_proof(stark, bad, config),
                  (EvmVerificationError, StarkVerificationError,
                   FriVerificationError), "")
    check(why is not None, "the port's verifier accepted a block proof "
          "with an opened value of the CPU table flipped")
    log(f"  ... and refuses it with one opened value of the CPU table "
        f"flipped in {time.perf_counter() - t:.2f} s ({why[:160]})")
    del bad, proof, traces
    torch.cuda.empty_cache()
    res.update(trace_gen_s=gen_s, shapes=shapes, programs=prog_line,
               verify_s=verify_s, asm_s=asm_s)
    return res


def check_plan_witness(sess, pw, dev) -> dict:
    """The session's kept witness plan against the host engine
    (iop/generator.py) on one random.Random(0) stream: the same
    (num_wires, degree) wires, byte for byte, and the same public
    inputs."""
    import random
    import torch
    from plonky2_tpu_torch.field.convert import to_u64
    from plonky2_tpu_torch.iop.device_witness import get_plan
    from plonky2_tpu_torch.iop.generator import generate_partial_witness
    po, common = sess.data.prover_only, sess.data.common
    plan = get_plan(po, common, pw, sess.device)
    check(plan is not None and plan.matches(pw), "no kept witness plan")
    waves = [(w.cls.__name__, int(w.dep.shape[-1])) for w in plan.waves]
    log(f"  witness plan: {len(waves)} waves (class, rows) {waves}; "
        f"{plan.n_slots} slots, {len(plan._prefix_gens)} random wires")
    wires, pis = plan.run(pw, random.Random(0))
    torch.cuda.synchronize()
    check(wires.device.type == dev.type, "the plan ran off the card")
    t = time.perf_counter()
    host = generate_partial_witness(pw, po, common, rng=random.Random(0))
    host_wires = host.full_witness()
    host_s = time.perf_counter() - t
    check(np.array_equal(to_u64(wires), host_wires),
          "the plan's wires differ from the host engine's")
    check(pis == host.get_targets(po.public_inputs),
          "the plan's public inputs differ from the host engine's")
    log(f"  the plan's wires ({tuple(wires.shape)}) equal the host engine's "
        f"full_witness() byte for byte (host engine {host_s:.3f} s)")
    return {"waves": waves, "n_slots": plan.n_slots, "host_engine_s": host_s}


def phase_probes(dev) -> dict:
    """The card's issue rate of independent 32x32 multiplies (mad.lo.u32,
    mad.wide.u32 with a 64-bit addend, mul.wide.u32 and mad.hi.u32; CUDA
    events over ~0.7 s of launches each) beside the rate the operation
    bounds assume, and the multiply instructions of one field product in
    the SASS, in goldilocks.cuh's form and in the older one of a * b
    and __umul64hi (csrc/probes/)."""
    import ctypes
    import re
    import torch
    from plonky2_tpu_torch import kernels
    info = kernels.build_probes()
    log(f"  probes built in {info['seconds']:.1f} s")
    lib = ctypes.CDLL(info["path"])
    fn = lib.plk_probe_mul_rate
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    chains = lib.plk_probe_chains()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads, iters = sms * 8, 256, 1 << 16
    out = torch.empty(blocks * threads, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {"sms": sms}
    for mode, label in enumerate(("mad.lo.u32", "mad.wide.u32",
                                  "mul.wide.u32", "mad.hi.u32")):
        def launch():
            rc = fn(out.data_ptr(), blocks, threads, iters, mode, dev.index,
                    stream)
            check(rc == 0, f"probe launch failed ({rc})")
        one_ms, _ = cuda_ms(launch)
        reps = max(1, int(700 / max(one_ms, 1e-3)))
        ms, _ = cuda_ms(lambda: [launch() for _ in range(reps)],
                        warmup=False)
        rate = blocks * threads * chains * iters * reps / (ms / 1e3)
        res[label] = rate
        log(f"  {label}: {rate / 1e12:.3f} T products/s over {ms:.1f} ms "
            f"({reps} launches; the bounds assume "
            f"{INT32_MULS_PER_S / 1e12:.3f} T/s)")
    dump = subprocess.run(
        [os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump"),
         "-sass", info["path"]], capture_output=True, text=True, timeout=120,
        check=True).stdout
    hist = {}
    for block in dump.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", block)
        hist[name] = {o: ops.count(o) for o in set(ops)}
    base = next(v for k, v in hist.items() if "field_baseline_probe" in k)
    for key, label in (("field_mul_probe", "mul_wide"),
                       ("field_mul_split_probe", "mul_wide_split"),
                       ("field_mul_umul64hi_probe", "umul64hi")):
        ops = next(v for k, v in hist.items() if key in k)
        diff = {o: ops.get(o, 0) - base.get(o, 0)
                for o in set(ops) | set(base)}
        diff = {o: n for o, n in sorted(diff.items()) if n}
        # multiplies: IMAD forms other than the move, add and shift ones;
        # IMAD.X is an add with carry on the same pipe
        muls = sum(n for o, n in diff.items() if o.startswith(
            ("IMAD", "IMUL")) and not o.startswith(
            ("IMAD.MOV", "IMAD.IADD", "IMAD.SHL", "IMAD.X")))
        res[f"field_product_muls_{label}"] = muls
        log(f"  one field product, {label} form: {muls} multiply "
            f"instructions; SASS beyond the baseline kernel: {diff}")
    return res


def kernels_line(kern, paths, smi, waves) -> dict:
    """One row per TPU kernel: its forms' numbers summed over the main
    paths, with the split by form and by path.  K7's row also has its
    latency floor on the session's proof: its waves times one permutation's
    latency over four lanes (phase 3c)."""
    def bound(nbytes, muls, fmas):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(muls / INT32_MULS_PER_S, fmas / FP64_FMAS_PER_S) * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
            "operations"

    out = []
    for key, (name, replaces) in TPU_KERNELS.items():
        entries = [e for e, v in KERNELS.items() if v[0] == key]
        cost = [0, 0, 0]
        path_cost = {k: [0, 0, 0] for k in paths}
        forms, launches, ms = [], {}, {}
        for entry in entries:
            c = [sum(p["cost"].get(entry, (0, 0, 0))[j]
                     for p in paths.values()) for j in range(3)]
            f_launches = {k: p["launches"][entry] for k, p in paths.items()}
            f_ms = {k: p["kernel_ms"].get(entry, 0.0)
                    for k, p in paths.items()}
            check(sum(f_launches.values()) > 0, f"{entry} was never launched")
            check(entry in kern, f"{entry} was not held against its plain "
                  "version")
            for k, p in paths.items():
                launches[k] = launches.get(k, 0) + f_launches[k]
                ms[k] = ms.get(k, 0.0) + f_ms[k]
                path_cost[k] = [x + y for x, y in zip(
                    path_cost[k], p["cost"].get(entry, (0, 0, 0)))]
            cost = [x + y for x, y in zip(cost, c)]
            f_bound, f_by = bound(*c)
            forms.append({"entry": entry, "form": KERNELS[entry][1],
                          "launches_by_path": f_launches,
                          "ms_by_path": f_ms, "ms": sum(f_ms.values()),
                          "bound_ms": f_bound, "bound_by": f_by,
                          "max_abs_err": kern[entry]["max_abs_err"],
                          **{k: kern[entry][k] for k in (
                              "plain_ms", "plain_shape",
                              "kernel_ms_at_plain_shape")
                             if k in kern[entry]}})
        timed = next(kern[e] for e in entries if "plain_ms" in kern[e])
        bound_ms, bound_by = bound(*cost)
        out.append({
            "name": name, "route": "cuda", "source": KERNELS[entries[0]][2],
            "replaces": replaces, "launches": sum(launches.values()),
            "max_abs_err": max(f["max_abs_err"] for f in forms),
            "ms": sum(ms.values()),
            "plain_ms": timed["plain_ms"], "plain_shape": timed["plain_shape"],
            "kernel_ms_at_plain_shape": timed["kernel_ms_at_plain_shape"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": cost[0], "bound_int32_muls": cost[1],
            "bound_fp64_fmas": cost[2],
            "library_ms": None, "launches_by_path": launches,
            "ms_by_path": ms,
            "bound_ms_by_path": {k: bound(*c)[0]
                                 for k, c in path_cost.items()},
            "forms": forms})
        if key == "K7":
            n = paths["session"]["k7_waves"]
            out[-1].update(session_waves=n,
                           latency_floor_ms=n * waves["perm_latency_ms"])
        if key == "K8":
            out[-1].update(record_phase3=kern.get("grind_record"),
                           record_session=paths["session"]["k8_record"])
        if key == "K9":
            # its permutations one after another, each one 4-lane
            # permutation's latency (phase 3c), on each path
            n = {}
            for k, p in paths.items():
                if p["launches"]["plk_sponge"]:
                    check("plk_sponge" in p["cost"], f"the {k} path "
                          "launched K9 and its recorder has no K9 cost")
                    n[k] = p["cost"]["plk_sponge"][1] // PERM_MULS
            out[-1].update(
                session_permutations=n["session"],
                latency_floor_ms=n["session"] * waves["perm_latency_ms"],
                permutations_by_path=n,
                latency_floor_ms_by_path={
                    k: v * waves["perm_latency_ms"] for k, v in n.items()})
    return {"kernels": out, "card": smi}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with phase("1 device"):
        smi = phase_device(dev)
    with phase("2 build"):
        phase_build()
    with phase("3 kernels vs plain (reduced shapes, exact)"):
        kern = phase_kernels(dev)
    with phase("3b K2's narrow levels: device time, host pace, one launch"):
        narrow = phase_narrow_levels(dev)
    with phase("3c K7's 18 waves: device time, host pace, one launch"):
        waves = phase_witness_waves(dev)
    rng = np.random.default_rng(SEED)
    with phase(f"4 full width ({NUM_POLYS} x 2^{LOG_N}, rate {RATE_BITS}, "
               f"cap {CAP_HEIGHT})"):
        full = phase_full_width(dev, rng)
    with phase(f"5 openings ({NUM_QUERIES} queries)"):
        phase_openings(full["batch"], rng)
    with phase("6 quotient round (full width: Z/PP 20 x 2^18, quotient "
               "coset 2^21)"):
        quot = phase_quotient(dev, rng, full)
    with phase("7 opening round (full width: 354 polynomials, 4 fold "
               "layers of arity 16, 28 queries, proof of work 16 bits)"):
        opening = phase_opening_round(dev, full, quot)
    with phase("8 prove, phases 2-8 (full width)"):
        proved = phase_prove(dev, full, quot, opening)
    with phase(f"9 proof at 2^{REDUCED_LOG_N} rows: card against CPU"):
        phase_reduced(dev, rng)
    paths = {"commit": full, "quotient": quot, "openings": opening,
             "prove": proved}
    for p in paths.values():     # the earlier phases' device state
        for key in ("batch", "values", "data", "challenger", "out",
                    "cs_batch", "openings", "proof"):
            p.pop(key, None)
    torch.cuda.empty_cache()
    with phase(f"9b circuit, witness, session (the flagship hash tree of "
               f"2^{SESSION_LOG2_LEAVES} leaves, built, proved and "
               "verified by the port)"):
        paths.update(phase_session(dev))
    with phase(f"9c the same tree under standard_recursion_config (135 "
               "wires), compiled, proved and verified"):
        paths["standard"] = phase_standard(dev)
    torch.cuda.empty_cache()
    with phase(f"9d the gate mix at 2^{GATE_MIX_LOG_N} rows (every gate of "
               "the recursion set, host witness), proved and verified"):
        paths["gate_mix"] = phase_gate_mix(dev)
    torch.cuda.empty_cache()
    with phase(f"9e the four-table EVM proof ({EVM_OPS} sponge ops: keccak, "
               "sponge, logic, memory with live CTLs), proved and "
               "verified"):
        paths["evm"] = phase_evm(dev)
    evm_proof = paths["evm"].pop("proof")
    torch.cuda.empty_cache()
    with phase(f"9f the Fibonacci STARK at 2^{FIB_LOG_N} rows, proved and "
               "verified"):
        paths["fib_stark"] = phase_fib_stark(dev)
    torch.cuda.empty_cache()
    with phase("9g System Zero at 2^16 rows (558 columns), proved and "
               "verified"):
        paths["system_zero"] = phase_system_zero(dev)
    torch.cuda.empty_cache()
    with phase(f"9h recursion: the no-op proof of 2^{RECURSION_INNER_LOG} "
               "rows, single and double recursion, compression, "
               f"{CYCLIC_STEPS} links of a cyclic chain"):
        paths["recursion"] = phase_recursion(dev)
    torch.cuda.empty_cache()
    with phase(f"9i wrapping: the Fibonacci STARK proof of 2^{FIB_LOG_N} "
               f"rows and the {EVM_OPS}-op EVM proof's four tables, each in "
               "a circuit, proved and verified, the aggregate checked"):
        fib = phase_wrap_fib(dev)
        torch.cuda.empty_cache()
        evm = phase_wrap_evm(dev, evm_proof)
        paths["wrap"] = dict(evm, **merge_paths([fib, evm]), fib=fib)
    del evm_proof, fib, evm
    torch.cuda.empty_cache()
    with phase("9j tree recursion: four leaves, two nodes and the root, "
               "proved and verified"):
        paths["tree"] = phase_tree(dev)
    torch.cuda.empty_cache()
    with phase("9k the U32, comparison and permutation gate set at 2^14 "
               "rows, proved and verified"):
        paths["gate_set"] = phase_gate_set(dev)
    torch.cuda.empty_cache()
    with phase("9l secp256k1 ECDSA verification in a circuit (98,660 gates, "
               "2^17 rows), proved and verified"):
        paths["ecdsa"] = phase_ecdsa(dev)
    torch.cuda.empty_cache()
    with phase("9m the range-checked arithmetic table (41,692 ops, 2^16 "
               "rows, 237 columns), proved and verified"):
        paths["arithmetic"] = phase_arithmetic(dev)
    torch.cuda.empty_cache()
    with phase("9n the zkEVM block proof of one signed transfer (CPU, "
               "keccak, sponge, logic, memory and arithmetic tables; the "
               "sender recovered in the kernel), proved and verified"):
        paths["block"] = phase_block(dev)
    with phase("10 kernels line"):
        line = kernels_line(kern, paths, smi, waves)
        line["narrow_levels"] = narrow
        line["witness_waves"] = waves
        line["k6_programs"] = kern["k6_programs"]
        line["paths"] = {
            k: {f: p[f] for f in ("cold_s", "warm_s", "peak_bytes",
                                  "resident_bytes", "profile") if f in p}
            for k, p in paths.items()}
        for k, p in paths.items():
            for f in ("stages_ms", "merkle_levels", "host", "k2_before",
                      "runs", "session_s", "generators", "host_rss_gib",
                      "plan_check", "grind", "k7_waves", "fri_paths",
                      "k8_record", "compile_ms", "k6_form", "build_s",
                      "build_stages_ms", "gates", "n_gates", "trace_gen_s",
                      "shapes", "programs", "verify_s", "links",
                      "double_bytes", "double_compressed_bytes",
                      "compress_s", "decompress_s", "cyclic", "fib",
                      "tables", "replay_s", "aggregate_s", "wrap_all_s",
                      "evm_setup_s", "place_s", "n_ops", "rows_used",
                      "degree_bits", "asm_s"):
                if f in p:
                    line["paths"][k][f] = p[f]
    with phase("11 int32 multiply rate and field-product SASS"):
        line["probes"] = phase_probes(dev)
    print(json.dumps(line), flush=True)
    print(f"total seconds: {time.perf_counter() - T0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
