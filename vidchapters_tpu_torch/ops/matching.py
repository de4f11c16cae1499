"""Linear sum assignment for set-prediction losses, on the host.

Counterpart of ``vidchapters_tpu/ops/matching.py``. ``auction_lsap`` is the
JAX package's default solver (an auction with the same rounds, eps,
escalating-eps continuation stages and completion sweep) written in numpy
float32, which gives its assignments: the same float32 operations in the
same order. The JAX package runs it on the device inside jit; here the cost
of a PDVC batch ([B, 100, 10]) is copied to the host once per decoder layer,
since a round of the auction is a handful of operations on [T, Q] and a
loop of them on the card would wait on the host every round.
``scipy_lsap`` is the exact oracle (``exact=True``), as there.

Shapes: cost [Q, T] with a validity mask over the T targets; the result is,
for each target, its assigned query (-1 for an invalid target).
"""

from __future__ import annotations

import numpy as np

BIG = 1e9


def scipy_lsap(cost: np.ndarray, n_valid: int) -> np.ndarray:
    """Exact LSAP: cost [Q, T] -> assignment [T] over the first ``n_valid``
    targets (-1 elsewhere)."""
    from scipy.optimize import linear_sum_assignment

    t = cost.shape[1]
    n = int(n_valid)
    out = np.full(t, -1, np.int32)
    if n > 0:
        rows, cols = linear_sum_assignment(cost[:, :n])
        out[cols] = rows.astype(np.int32)
    return out


def auction_lsap(cost: np.ndarray, valid: np.ndarray, num_iters: int = 4000,
                 eps: float = 1e-4, phases: int = 7, theta: float = 10.0) -> np.ndarray:
    """Min-cost assignment by a forward auction (the JAX package's solver;
    its docstring has the design and the grid search behind the defaults).

    Each unassigned valid target bids for its best query (by value minus
    price) with the increment best - second best + eps; per query the highest
    bidder wins, evicting the previous owner. Invalid targets carry -BIG
    values and never keep the auction running. If a stage hits its round
    cap with valid targets unassigned, up to ``phases - 1`` further stages
    continue with eps multiplied by ``theta`` each, keeping assignments and
    prices. A final sweep gives any still-unassigned target its best free
    query. cost [Q, T] float32, valid [T] -> [T] int32."""
    cost = np.asarray(cost, np.float32)
    q, t = cost.shape
    valid_b = np.asarray(valid) > 0
    f32 = np.float32
    value = np.where(valid_b[:, None], -cost.T, f32(-BIG)).astype(np.float32)  # [T, Q]
    prices = np.zeros(q, np.float32)
    owner = np.full(q, -1, np.int32)
    assign = np.full(t, -1, np.int32)
    cols = np.arange(q)
    stage_cap = max(num_iters // 4, 64)
    for k in range(phases):
        phase_eps = f32(eps) * np.power(f32(theta), f32(k), dtype=np.float32)
        cap = num_iters if k == 0 else stage_cap
        it = 0
        while it < cap and np.any((assign < 0) & valid_b):
            unassigned = (assign < 0) & valid_b
            net = value - prices[None, :]
            best_q = np.argmax(net, axis=1)
            best_v = net[np.arange(t), best_q]
            is_best = cols[None, :] == best_q[:, None]
            second_v = np.where(is_best, f32(-np.inf), net).max(axis=1)
            second_v = np.where(np.isfinite(second_v), second_v, best_v)
            bid = (best_v - second_v) + phase_eps
            bid_matrix = np.where(unassigned[:, None] & is_best, bid[:, None], f32(-np.inf))
            winner_t = np.argmax(bid_matrix, axis=0).astype(np.int32)  # [Q]
            winner_bid = bid_matrix[winner_t, cols]
            has_bid = np.isfinite(winner_bid)
            evicted = owner[has_bid & (owner >= 0)]
            owner = np.where(has_bid, winner_t, owner)
            prices = np.where(has_bid, prices + winner_bid, prices).astype(np.float32)
            assign[evicted] = -1
            assign[winner_t[has_bid]] = cols[has_bid]
            it += 1
    # completion sweep: one unassigned target per round takes its best free query
    for _ in range(t):
        free_q = np.ones(q, bool)
        free_q[assign[assign >= 0]] = False
        unassigned = (assign < 0) & valid_b
        if not (unassigned.any() and free_q.any()):
            continue
        idx = int(np.argmax(unassigned))
        assign[idx] = int(np.argmax(np.where(free_q, value[idx], f32(-BIG))))
    return np.where(valid_b, assign, -1).astype(np.int32)


def hungarian_match(cost, valid, exact: bool = False) -> np.ndarray:
    """[Q, T] cost + [T] validity (arrays or CPU tensors) -> [T] assigned
    query per target (-1 invalid). ``exact=True`` solves with scipy (the
    reference matcher's semantics); the default is the auction."""
    cost = np.asarray(cost, np.float32)
    valid = np.asarray(valid) > 0
    if exact:
        return scipy_lsap(np.where(valid[None, :], cost, np.float32(BIG)), int(valid.sum()))
    return auction_lsap(cost, valid)
