"""The quadratic, quartic and quintic Goldilocks extensions: scalar
arithmetic of F_p[X]/(X^D - W) over tuples of ints.  The port's copy of
plonky2_tpu/field/extension_towers.py (reference field/src/extension/
{quadratic,quartic,quintic}.rs, goldilocks_extensions.rs).

The prover's quadratic extension is the vectorised field/extension.py;
this module is the generic tower, which no proof runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from .goldilocks import P, POWER_OF_TWO_GENERATOR


@dataclass(frozen=True)
class ExtensionParams:
    d: int
    w: int
    dth_root: int
    ext_multiplicative_group_generator: Tuple[int, ...]
    ext_power_of_two_generator: Tuple[int, ...]


# reference goldilocks_extensions.rs:14-92
QUADRATIC = ExtensionParams(
    d=2, w=7, dth_root=18446744069414584320,
    ext_multiplicative_group_generator=(18081566051660590251,
                                        16121475356294670766),
    ext_power_of_two_generator=(0, 15659105665374529263))

QUARTIC = ExtensionParams(
    d=4, w=7, dth_root=281474976710656,
    ext_multiplicative_group_generator=(5024755240244648895,
                                        13227474371289740625,
                                        3912887029498544536,
                                        3900057112666848848),
    ext_power_of_two_generator=(0, 0, 0, 12587610116473453104))

QUINTIC = ExtensionParams(
    d=5, w=3, dth_root=1041288259238279555,
    ext_multiplicative_group_generator=(2899034827742553394,
                                        13012057356839176729,
                                        14593811582388663055,
                                        7722900811313895436,
                                        4557222484695340057),
    ext_power_of_two_generator=(POWER_OF_TWO_GENERATOR, 0, 0, 0, 0))

TOWERS = {2: QUADRATIC, 4: QUARTIC, 5: QUINTIC}


def zero(params: ExtensionParams) -> Tuple[int, ...]:
    return (0,) * params.d


def one(params: ExtensionParams) -> Tuple[int, ...]:
    return (1,) + (0,) * (params.d - 1)


def from_base(params: ExtensionParams, x: int) -> Tuple[int, ...]:
    return (x % P,) + (0,) * (params.d - 1)


def add(params, a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def sub(params, a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def neg(params, a):
    return tuple((-x) % P for x in a)


def scalar_mul(params, a, s: int):
    return tuple(x * s % P for x in a)


def mul(params, a, b):
    """The schoolbook product, X^D folded to W."""
    d, w = params.d, params.w
    out = [0] * d
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            k = i + j
            term = ai * bj
            if k >= d:
                out[k - d] = (out[k - d] + term * w) % P
            else:
                out[k] = (out[k] + term) % P
    return tuple(out)


def exp(params, a, e: int):
    result = one(params)
    base = a
    while e:
        if e & 1:
            result = mul(params, result, base)
        base = mul(params, base, base)
        e >>= 1
    return result


def frobenius(params, a, k: int = 1):
    """sigma^k(a): a_j -> a_j * DTH_ROOT^(k*j) (p = 1 mod D, so
    X^(p^k) = X * DTH_ROOT^k)."""
    return tuple(aj * pow(params.dth_root, k * j, P) % P
                 for j, aj in enumerate(a))


def inverse(params, a):
    """a^-1 = (prod_{i>0} sigma^i(a)) / N(a), the norm N(a) in the base
    field (reference extension/mod.rs, the OEF inverse)."""
    if a == zero(params):
        raise ZeroDivisionError("inverse of zero")
    frob_prod = frobenius(params, a, 1)
    for i in range(2, params.d):
        frob_prod = mul(params, frob_prod, frobenius(params, a, i))
    norm_full = mul(params, a, frob_prod)
    if any(norm_full[1:]):
        raise ArithmeticError("the norm is not in the base field")
    return scalar_mul(params, frob_prod, pow(norm_full[0], P - 2, P))
