"""PGD's restart arbitration (kernel K15's twin, ``restart_plain``, through
``restart`` on the CPU) against the JAX package's ``restart`` body, exactly.

JAX's body is a closure inside ``ConstrainedPGD._build``'s jitted attack
(JAX ``attacks/pgd/engine.py:311``), so :func:`jax_restarts` runs it as
written there, over a ``lax.fori_loop`` of the same runs: a row keeps the
first run that succeeds on it, its history follows the kept run (an
unsuccessful row's the latest run), and the cumulative success after each
run is recorded. The runs are numpy-seeded stand-ins for the PGD kernel's
(x_adv, pred, hist)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import restart, restart_plain

N, D, T, C = 37, 6, 5, 4


def runs(n_starts: int, seed: int, record: bool):
    """``n_starts`` runs: rows (N, D), classes (N,) in {0, 1} and, with
    ``record``, histories (T, N, C)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_starts):
        x_adv = rng.normal(size=(N, D)).astype(np.float32)
        pred = rng.integers(0, 2, N)
        hist = rng.normal(size=(T, N, C)).astype(np.float32) if record else None
        out.append((x_adv, pred, hist))
    return out


def jax_restarts(run_list, x_init, y, targeted: bool, record: bool):
    """JAX's ``restart`` body over ``run_list`` in a ``fori_loop``, the
    history starting from ``_hist_init``'s zeros."""
    xs = jnp.asarray(np.stack([r[0] for r in run_list]))
    preds = jnp.asarray(np.stack([r[1] for r in run_list]))
    hists = jnp.asarray(np.stack([r[2] for r in run_list])) if record else None
    n_starts = len(run_list)

    def restart_body(r, carry):
        best_x, best_success, best_hist, succ_hist = carry
        x_adv, pred = xs[r], preds[r]
        success = pred != y  # untargeted flip
        if targeted:
            success = pred == y
        take = success & ~best_success
        best_x = jnp.where(take[:, None], x_adv, best_x)
        if record:
            upd = take | ~(best_success | success)
            best_hist = jnp.where(upd[None, :, None], hists[r], best_hist)
        best_success = best_success | success
        succ_hist = succ_hist.at[r].set(best_success)
        return best_x, best_success, best_hist, succ_hist

    hist0 = jnp.zeros((T, N, C), jnp.float32) if record else jnp.zeros((), jnp.float32)
    init = (jnp.asarray(x_init), jnp.zeros(N, bool), hist0, jnp.zeros((n_starts, N), bool))
    best, _, hist, succ = jax.lax.fori_loop(0, n_starts, restart_body, init)
    return np.asarray(best), (np.asarray(hist) if record else None), np.asarray(succ)


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("targeted", [False, True])
@pytest.mark.parametrize("n_starts", [1, 3])
def test_restart_equals_jax(n_starts, targeted, record):
    seed = 10 * n_starts + 2 * targeted + record
    run_list = runs(n_starts, seed, record)
    rng = np.random.default_rng(seed + 100)
    x_init = rng.normal(size=(N, D)).astype(np.float32)
    y = rng.integers(0, 2, N)
    want_x, want_hist, want_succ = jax_restarts(run_list, x_init, jnp.asarray(y), targeted, record)

    best_x, best_hist = torch.as_tensor(x_init), None
    y_t = torch.as_tensor(y)
    curve = torch.empty((n_starts, N), dtype=torch.bool)
    for r, (x_adv, pred, hist) in enumerate(run_list):
        best_x, best_hist = restart(
            torch.as_tensor(x_adv), torch.as_tensor(pred), y_t, None if hist is None else torch.as_tensor(hist),
            best_x, best_hist, curve, r, targeted,
        )
    np.testing.assert_array_equal(best_x.numpy(), want_x)
    np.testing.assert_array_equal(curve.numpy(), want_succ)
    if record:
        np.testing.assert_array_equal(best_hist.numpy(), want_hist)
    else:
        assert best_hist is None
    # some rows keep a later start and some none: the cases are exercised
    assert want_succ[-1].any() and not want_succ[-1].all()


def test_restart_plain_first_start_copies_the_history():
    (x_adv, pred, hist), = runs(1, 7, True)
    x_init = torch.zeros((N, D))
    y = torch.as_tensor(pred)  # no row flips
    best_x, best_hist, success = restart_plain(
        torch.as_tensor(x_adv), torch.as_tensor(pred), y, torch.as_tensor(hist), x_init, None,
        torch.zeros(N, dtype=torch.bool), False,
    )
    assert torch.equal(best_x, x_init) and not success.any()
    assert torch.equal(best_hist, torch.as_tensor(hist))
