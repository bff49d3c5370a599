"""Adaptation metrics: what "robust adaptive control" means, measured.

All metrics reduce a per-step reward array (``(T,)`` or ``(T, B)``, fleet
axis averaged) around a perturbation onset:

  * ``pre``      — mean reward rate over the window before the onset (the
                   adapted, healthy behaviour).
  * ``post``     — mean over the window right after the onset (the damage).
  * ``final``    — mean over the last window of the episode (where the
                   controller ends up).
  * ``drop``     — ``pre - post``: the perturbation-induced return drop.
  * ``recovery_frac`` — ``(final - post) / drop``: the fraction of the drop
                   won back by the end.  1 = full recovery, 0 = none; the
                   paper's claim is that plasticity recovers while frozen
                   weights do not.
  * ``time_to_recover`` — env steps after onset until the trailing
                   window-mean first re-crosses ``pre - (1 - target) *
                   drop`` (default target 0.5, i.e. half the drop won
                   back); -1 if it never does.
"""
from __future__ import annotations

import numpy as np


def adaptation_metrics(rewards, onset: int, window: int = 20,
                       target: float = 0.5) -> dict:
    """Pre/post/final reward rates + recovery around a perturbation onset.

    `rewards` may be a tensor or an array, ``(T,)`` or ``(T, B)`` (B
    averaged).
    ``onset`` is the nominal perturbation step; ``window`` the averaging
    span (clipped to what the episode affords).
    """
    if hasattr(rewards, "detach"):
        rewards = rewards.detach().cpu().numpy()
    r = np.asarray(rewards, np.float64)
    if r.ndim == 2:
        r = r.mean(axis=1)
    t_total = r.shape[0]
    if not 0 < onset < t_total:
        raise ValueError(f"onset {onset} outside episode of {t_total} steps")
    w = max(1, min(window, onset, t_total - onset))
    pre = float(r[onset - w:onset].mean())
    post = float(r[onset:onset + w].mean())
    final = float(r[t_total - w:].mean())
    drop = pre - post
    recovery = (final - post) / drop if abs(drop) > 1e-9 else float("nan")

    # trailing window-mean after onset; first crossing of the recovery bar
    bar = pre - (1.0 - target) * drop
    ttr = -1
    if drop > 1e-9:
        csum = np.concatenate([[0.0], np.cumsum(r)])
        # a full window must clear the bar (a single lucky step must not)
        for t in range(onset + w, t_total + 1):
            if (csum[t] - csum[t - w]) / w >= bar:
                ttr = t - onset
                break
    return {"pre": pre, "post": post, "final": final, "drop": drop,
            "recovery_frac": float(recovery), "time_to_recover": ttr,
            "window": w, "onset": onset}


def ablation_summary(plastic: dict, frozen: dict) -> dict:
    """Side-by-side of a plasticity-on run and its frozen-weights ablation
    (same seed, same schedule): the paper's core claim is
    ``plastic.recovery_frac`` high while ``frozen.recovery_frac`` is not."""
    return {
        "plastic": plastic, "frozen": frozen,
        "recovery_gap": plastic["recovery_frac"] - frozen["recovery_frac"],
    }
