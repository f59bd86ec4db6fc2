"""The port's copy of plonky2_tpu/evm/kernel/opcodes.py.

EVM (+ kernel-only) opcode table (reference evm/src/cpu/kernel/opcodes.rs)."""
from __future__ import annotations

_BASE = {
    "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04,
    "SDIV": 0x05, "MOD": 0x06, "SMOD": 0x07, "ADDMOD": 0x08, "MULMOD": 0x09,
    "EXP": 0x0A, "SIGNEXTEND": 0x0B, "ADDFP254": 0x0C, "MULFP254": 0x0D,
    "SUBFP254": 0x0E, "LT": 0x10, "GT": 0x11, "SLT": 0x12, "SGT": 0x13,
    "EQ": 0x14, "ISZERO": 0x15, "AND": 0x16, "OR": 0x17, "XOR": 0x18,
    "NOT": 0x19, "BYTE": 0x1A, "SHL": 0x1B, "SHR": 0x1C, "SAR": 0x1D,
    "KECCAK256": 0x20, "KECCAK_GENERAL": 0x21, "ADDRESS": 0x30,
    "BALANCE": 0x31, "ORIGIN": 0x32, "CALLER": 0x33, "CALLVALUE": 0x34,
    "CALLDATALOAD": 0x35, "CALLDATASIZE": 0x36, "CALLDATACOPY": 0x37,
    "CODESIZE": 0x38, "CODECOPY": 0x39, "GASPRICE": 0x3A,
    "EXTCODESIZE": 0x3B, "EXTCODECOPY": 0x3C, "RETURNDATASIZE": 0x3D,
    "RETURNDATACOPY": 0x3E, "EXTCODEHASH": 0x3F, "BLOCKHASH": 0x40,
    "COINBASE": 0x41, "TIMESTAMP": 0x42, "NUMBER": 0x43, "DIFFICULTY": 0x44,
    "GASLIMIT": 0x45, "CHAINID": 0x46, "BASEFEE": 0x48, "PROVER_INPUT": 0x49,
    "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52, "MSTORE8": 0x53,
    "SLOAD": 0x54, "SSTORE": 0x55, "JUMP": 0x56, "JUMPI": 0x57,
    "GETPC": 0x58, "MSIZE": 0x59, "GAS": 0x5A, "JUMPDEST": 0x5B,
    "LOG0": 0xA0, "LOG1": 0xA1, "LOG2": 0xA2, "LOG3": 0xA3, "LOG4": 0xA4,
    "PANIC": 0xA5, "CREATE": 0xF0, "CALL": 0xF1, "CALLCODE": 0xF2,
    "RETURN": 0xF3, "DELEGATECALL": 0xF4, "CREATE2": 0xF5,
    "GET_CONTEXT": 0xF6, "SET_CONTEXT": 0xF7, "CONSUME_GAS": 0xF8,
    "EXIT_KERNEL": 0xF9, "STATICCALL": 0xFA, "MLOAD_GENERAL": 0xFB,
    "MSTORE_GENERAL": 0xFC, "REVERT": 0xFD, "INVALID": 0xFE,
    "SELFDESTRUCT": 0xFF,
}
for _i in range(16):
    _BASE[f"DUP{_i + 1}"] = 0x80 + _i
    _BASE[f"SWAP{_i + 1}"] = 0x90 + _i


def get_opcode(mnemonic: str) -> int:
    try:
        return _BASE[mnemonic.upper()]
    except KeyError:
        raise ValueError(f"Unrecognized mnemonic {mnemonic}") from None


def get_push_opcode(n: int) -> int:
    assert 1 <= n <= 32
    return 0x60 + n - 1


def is_mnemonic(s: str) -> bool:
    return s.upper() in _BASE
