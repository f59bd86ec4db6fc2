"""The logic table: 256-bit AND/OR/XOR with bit-decomposed inputs and
32-bit-limb results.  The port's copy of plonky2_tpu/evm/logic.py
(reference evm/src/logic.rs), its trace generator written with numpy
array ops."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..stark.stark import Stark
from .cross_table_lookup import Column

VAL_BITS = 256
PACKED_LIMB_BITS = 32
PACKED_LEN = -(-VAL_BITS // PACKED_LIMB_BITS)  # 8

IS_AND = 0
IS_OR = IS_AND + 1
IS_XOR = IS_OR + 1
INPUT0 = range(IS_XOR + 1, IS_XOR + 1 + VAL_BITS)
INPUT1 = range(INPUT0.stop, INPUT0.stop + VAL_BITS)
RESULT = range(INPUT1.stop, INPUT1.stop + PACKED_LEN)
NUM_COLUMNS = RESULT.stop


def limb_bit_cols_for_input(input_bits: range) -> List[range]:
    out = []
    for i in range(PACKED_LEN):
        start = input_bits.start + i * PACKED_LIMB_BITS
        end = min(start + PACKED_LIMB_BITS, input_bits.stop)
        out.append(range(start, end))
    return out


def ctl_data() -> List[Column]:
    res = [Column.single(IS_AND), Column.single(IS_OR), Column.single(IS_XOR)]
    res.extend(Column.le_bits(r) for r in limb_bit_cols_for_input(INPUT0))
    res.extend(Column.le_bits(r) for r in limb_bit_cols_for_input(INPUT1))
    res.extend(Column.single(c) for c in RESULT)
    return res


def ctl_filter() -> Column:
    return Column.sum_cols([IS_AND, IS_OR, IS_XOR])


@dataclass
class Operation:
    operator: str  # "and" | "or" | "xor"
    input0: int    # 256-bit values
    input1: int

    @property
    def result(self) -> int:
        if self.operator == "and":
            return self.input0 & self.input1
        if self.operator == "or":
            return self.input0 | self.input1
        if self.operator == "xor":
            return self.input0 ^ self.input1
        raise ValueError(self.operator)


class LogicStark(Stark):
    COLUMNS = NUM_COLUMNS
    PUBLIC_INPUTS = 0

    def generate_trace(self, operations: List[Operation],
                       min_rows: int = 8) -> np.ndarray:
        n = max(len(operations), min_rows)
        n = 1 << (n - 1).bit_length()
        trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
        if not operations:
            return trace
        k = len(operations)
        col = {"and": IS_AND, "or": IS_OR, "xor": IS_XOR}
        trace[[col[op.operator] for op in operations], np.arange(k)] = 1

        def le_bytes(values):
            return np.frombuffer(b"".join(v.to_bytes(VAL_BITS // 8, "little")
                                          for v in values),
                                 dtype=np.uint8).reshape(k, -1)

        for rows, values in ((INPUT0, [op.input0 for op in operations]),
                             (INPUT1, [op.input1 for op in operations])):
            bits = np.unpackbits(le_bytes(values), axis=1, bitorder="little")
            trace[rows.start:rows.stop, :k] = bits.T
        limbs = le_bytes([op.result for op in operations]).view("<u4")
        trace[RESULT.start:RESULT.stop, :k] = limbs.T
        return trace

    def eval(self, alg, vars, yield_constr) -> None:
        lv = vars.local_values
        is_and, is_or, is_xor = lv[IS_AND], lv[IS_OR], lv[IS_XOR]

        # in0 OP in1 = sum_coeff*(in0 + in1) + and_coeff*(in0 AND in1):
        # AND => (0, 1); OR => (1, -1); XOR => (1, -2)
        sum_coeff = alg.add(is_or, is_xor)
        and_coeff = alg.sub(alg.sub(is_and, is_or),
                            alg.mul_const(is_xor, 2))

        for input_bits in (INPUT0, INPUT1):
            for i in input_bits:
                bit = lv[i]
                yield_constr.constraint(alg.sub(alg.mul(bit, bit), bit))

        for result_col, x_cols, y_cols in zip(
                RESULT, limb_bit_cols_for_input(INPUT0),
                limb_bit_cols_for_input(INPUT1)):
            x = alg.zero()
            y = alg.zero()
            x_land_y = alg.zero()
            for i, (xc, yc) in enumerate(zip(x_cols, y_cols)):
                w = 1 << i
                x = alg.add(x, alg.mul_const(lv[xc], w))
                y = alg.add(y, alg.mul_const(lv[yc], w))
                x_land_y = alg.add(x_land_y,
                                   alg.mul_const(alg.mul(lv[xc], lv[yc]), w))
            x_op_y = alg.add(alg.mul(sum_coeff, alg.add(x, y)),
                             alg.mul(and_coeff, x_land_y))
            yield_constr.constraint(alg.sub(lv[result_col], x_op_y))

    def constraint_degree(self) -> int:
        return 3
