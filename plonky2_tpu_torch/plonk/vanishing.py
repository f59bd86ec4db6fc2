"""The vanishing polynomial at one point, against an algebra (the port's
copy of plonky2_tpu/plonk/vanishing.py; reference
plonky2/src/plonk/vanishing_poly.rs, util/partial_products.rs).

The verifier evaluates it on the extension at zeta (plonk/verifier.py),
with the challenges as ints; plonk/quotient_program.py traces it into the
quotient's constraint program, with the challenges as the program's scalar
inputs (algebra values).
"""
from __future__ import annotations

from typing import List

from ..field import extension as ge
from ..field import goldilocks as gl
from .algebra import EvaluationVars


def evaluate_gate_constraints(alg, common_data, vars: EvaluationVars) -> list:
    constraints = [alg.zero()] * common_data.num_gate_constraints
    info = common_data.selectors_info
    for i, gate in enumerate(common_data.gates):
        sel_idx = info.selector_indices[i]
        cs = gate.eval_filtered(alg, vars, i, sel_idx, info.groups[sel_idx],
                                info.num_selectors())
        for j, c in enumerate(cs):
            constraints[j] = alg.add(constraints[j], c)
    return constraints


def check_partial_products(alg, numerators: list, denominators: list,
                           partials: list, z_x, z_gx, max_degree: int) -> list:
    """prev_acc * prod(num_chunk) - next_acc * prod(den_chunk) per chunk
    (reference util/partial_products.rs:52-78)."""
    accs = [z_x] + list(partials) + [z_gx]
    out = []
    for chunk_i, idx in enumerate(range(0, len(numerators), max_degree)):
        chunk = range(idx, min(idx + max_degree, len(numerators)))
        num_prod = den_prod = None
        for j in chunk:
            num_prod = (numerators[j] if num_prod is None
                        else alg.mul(num_prod, numerators[j]))
            den_prod = (denominators[j] if den_prod is None
                        else alg.mul(den_prod, denominators[j]))
        out.append(alg.sub(alg.mul(accs[chunk_i], num_prod),
                           alg.mul(accs[chunk_i + 1], den_prod)))
    return out


def reduce_with_powers(alg, terms: list, alpha) -> object:
    acc = alg.zero()
    for t in reversed(terms):
        acc = alg.add(alg.mul(acc, alpha), t)
    return acc


def eval_vanishing_poly(alg, common_data, x, vars: EvaluationVars,
                        local_zs: list, next_zs: list, partial_products: list,
                        s_sigmas: list, betas: List[int], gammas: List[int],
                        alphas: List[int], l_0_x) -> list:
    """The num_challenges alpha-reduced vanishing values at `x` (an
    algebra value), with L_0(x) given in the same algebra; the challenges
    are base-field ints or algebra values (JAX :58-112)."""
    max_degree = common_data.quotient_degree_factor
    num_prods = common_data.num_partial_products
    num_routed = common_data.config.num_routed_wires

    constraint_terms = evaluate_gate_constraints(alg, common_data, vars)

    vanishing_z_1_terms = []
    vanishing_partial_products_terms = []
    for i in range(common_data.config.num_challenges):
        z_x = local_zs[i]
        z_gx = next_zs[i]
        vanishing_z_1_terms.append(alg.mul(l_0_x,
                                           alg.add_const(z_x, gl.P - 1)))
        beta, gamma = betas[i], gammas[i]
        numerators = []
        denominators = []
        for j in range(num_routed):
            wire = vars.local_wires[j]
            if isinstance(beta, int):
                bk = (beta * common_data.k_is[j]) % gl.P
                num = alg.add(wire, alg.mul_const(x, bk))
                den = alg.add(wire, alg.mul_const(s_sigmas[j], beta))
            else:
                num = alg.add(wire, alg.mul(
                    x, alg.mul_const(beta, common_data.k_is[j])))
                den = alg.add(wire, alg.mul(s_sigmas[j], beta))
            if isinstance(gamma, int):
                numerators.append(alg.add_const(num, gamma))
                denominators.append(alg.add_const(den, gamma))
            else:
                numerators.append(alg.add(num, gamma))
                denominators.append(alg.add(den, gamma))
        pps = partial_products[i * num_prods:(i + 1) * num_prods]
        vanishing_partial_products_terms.extend(
            check_partial_products(alg, numerators, denominators, pps,
                                   z_x, z_gx, max_degree))

    terms = (vanishing_z_1_terms + vanishing_partial_products_terms
             + constraint_terms)
    return [reduce_with_powers(alg, terms,
                               alg.const(a) if isinstance(a, int) else a)
            for a in alphas]


def eval_l_0_ext(alg, n: int, x):
    """L_0(x) = (x^n - 1) / (n (x - 1)) on the extension (reference
    plonk_common.rs:57-67)."""
    if x == (1, 0):
        return alg.one()
    zx = alg.add_const(alg.exp(x, n), gl.P - 1)
    den = alg.mul_const(alg.add_const(x, gl.P - 1), n)
    return alg.mul(zx, ge.s_inv(den))
