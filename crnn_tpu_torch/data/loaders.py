"""Experimental-data loaders: the Cathode DSC CSVs, their UQ replicates, and
the synthetic surrogate (port of crnn_tpu/data/loaders.py, numpy only).

The Cathode reference fits measured DSC heat-release curves
(Cathode/src/dataset.jl:5-25): per heating rate beta, a CSV of
[temperature_C, HRR] rows; duplicate temperatures are dropped and the
temperature axis is converted to time via t = (T - 100) * 60 / beta.

The experimental CSVs are not redistributed here; ``load_cathode_dir``
reads them from a user-supplied directory in the same format, and
``synthetic_dsc`` generates replacement curves from a known 3-reaction
extended-Arrhenius decomposition, so tests and demo runs are
self-contained. Every function here is the JAX package's own numpy and
scipy code, so both packages load and generate the same arrays.

Ragged curves are padded to a common length with validity masks:
fixed-shape (n_exp, n_max) arrays.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Sequence

import numpy as np

HEATING_RATES = (2.0, 5.0, 10.0, 15.0, 20.0)  # K/min (dataset.jl:16)


class DSCData(NamedTuple):
    ts: np.ndarray       # (n_exp, n_max) solve times [s], padded with t_end
    hrr: np.ndarray      # (n_exp, n_max) measured heat release, padded 0
    mask: np.ndarray     # (n_exp, n_max) 1 = real sample
    betas: np.ndarray    # (n_exp,) heating rates [K/min]
    n_points: np.ndarray  # (n_exp,) true lengths


def _dedup_first_column(arr: np.ndarray) -> np.ndarray:
    _, idx = np.unique(arr[:, 0], return_index=True)
    return arr[np.sort(idx)]


def load_cathode_csv(path: str, beta: float,
                     t_ref_celsius: float = 100.0) -> np.ndarray:
    """One curve: [T_C, HRR] -> [t_s, HRR] (dedup + T->t conversion)."""
    arr = np.loadtxt(path, delimiter=",", dtype=np.float64)
    arr = _dedup_first_column(arr)
    t = (arr[:, 0] - t_ref_celsius) * 60.0 / beta
    return np.stack([t, arr[:, 1]], axis=1)


def pack_curves(curves: List[np.ndarray], betas: Sequence[float]) -> DSCData:
    """Pad ragged [t, hrr] curves to fixed shape with masks."""
    n_max = max(c.shape[0] for c in curves)
    n_exp = len(curves)
    ts = np.zeros((n_exp, n_max))
    hrr = np.zeros((n_exp, n_max))
    mask = np.zeros((n_exp, n_max))
    n_points = np.zeros((n_exp,), np.int32)
    for i, c in enumerate(curves):
        n = c.shape[0]
        ts[i, :n] = c[:, 0]
        ts[i, n:] = c[-1, 0]     # pad with t_end: interpolation stays valid
        hrr[i, :n] = c[:, 1]
        mask[i, :n] = 1.0
        n_points[i] = n
    return DSCData(ts=ts, hrr=hrr, mask=mask,
                   betas=np.asarray(betas, np.float64), n_points=n_points)


def load_cathode_dir(data_dir: str, cathode_num: int = 1,
                     heating_rates: Sequence[float] = HEATING_RATES
                     ) -> DSCData:
    """Load cath_<num>_<beta>.csv for each heating rate (dataset.jl:17-24)."""
    curves = [
        load_cathode_csv(
            os.path.join(data_dir, f"cath_{cathode_num}_{int(b)}.csv"), b
        )
        for b in heating_rates
    ]
    return pack_curves(curves, heating_rates)


class ReplicateDSCData(NamedTuple):
    ts: np.ndarray       # (n_exp, n_max) solve times [s], padded with t_end
    reps: np.ndarray     # (n_exp, n_max, n_rep) replicate HRR curves, pad 0
    mask: np.ndarray     # (n_exp, n_max) 1 = real sample
    betas: np.ndarray    # (n_exp,) heating rates [K/min]
    n_points: np.ndarray  # (n_exp,) true lengths


def load_uncert_csv(path: str, beta: float,
                    t_ref_celsius: float = 100.0) -> np.ndarray:
    """One replicate file: [T_C, hrr_1 .. hrr_R] -> [t_s, hrr_1 .. hrr_R].

    The UQ reference's format (Cathode_NCM333_UQ/src_333/dataset.jl:5-24):
    first column is the instrument temperature in Celsius, the remaining
    columns are noisy replicate heat-release measurements; duplicate
    temperatures are dropped and t = (T - 100) * 60 / beta.
    """
    arr = np.loadtxt(path, delimiter=",", dtype=np.float64)
    arr = _dedup_first_column(arr)
    t = (arr[:, 0] - t_ref_celsius) * 60.0 / beta
    return np.concatenate([t[:, None], arr[:, 1:]], axis=1)


def load_uncert_dir(data_dir: str, cathode_num: int = 1,
                    heating_rates: Sequence[float] = HEATING_RATES
                    ) -> ReplicateDSCData:
    """Load UNCERT_cath_<num>_<beta>.csv replicate curves, padded to fixed
    (n_exp, n_max, n_rep) with per-row validity masks."""
    curves = [
        load_uncert_csv(
            os.path.join(data_dir, f"UNCERT_cath_{cathode_num}_{int(b)}.csv"),
            b
        )
        for b in heating_rates
    ]
    n_rep = min(c.shape[1] - 1 for c in curves)
    n_max = max(c.shape[0] for c in curves)
    n_exp = len(curves)
    ts = np.zeros((n_exp, n_max))
    reps = np.zeros((n_exp, n_max, n_rep))
    mask = np.zeros((n_exp, n_max))
    n_points = np.zeros((n_exp,), np.int32)
    for i, c in enumerate(curves):
        n = c.shape[0]
        ts[i, :n] = c[:, 0]
        ts[i, n:] = c[-1, 0]
        reps[i, :n] = c[:, 1:1 + n_rep]
        mask[i, :n] = 1.0
        n_points[i] = n
    return ReplicateDSCData(
        ts=ts, reps=reps, mask=mask,
        betas=np.asarray(heating_rates, np.float64), n_points=n_points,
    )


def synthetic_dsc(
    seed: int = 0,
    heating_rates: Sequence[float] = HEATING_RATES,
    noise: float = 0.02,
    t0_celsius: float = 110.0,
    t1_celsius: float = 400.0,
    dT: float = 6.0,
) -> DSCData:
    """Generate DSC curves from a known 3-reaction sequential decomposition
    c1 -> c2 -> c3 -> (gone) with extended Arrhenius kinetics, sampled on a
    temperature grid like the real instrument output."""
    from scipy.integrate import solve_ivp

    rng = np.random.default_rng(seed)
    # ground-truth kinetics (lnA, b, Ea[J/mol * 1e-5], order, delH, nu)
    ln_a = np.array([22.0, 24.0, 26.0])
    b_t = np.array([0.0, 0.0, 0.0])
    ea = np.array([1.05, 1.20, 1.40]) * 1e5
    order = np.array([1.0, 1.0, 1.0])
    del_h = np.array([120.0, 60.0, 90.0])
    nu = np.array([1.0, 0.9, 0.8])
    R = 8.314
    t_ref = 373.15  # 100 C in K

    def rates(y, T):
        logx = np.log(np.clip(y, 1e-10, 10.0))
        return np.exp(ln_a + b_t * np.log(T) - ea / (R * T) + order * logx)

    curves = []
    for beta in heating_rates:
        temps_c = np.arange(t0_celsius, t1_celsius, dT)
        times = (temps_c - 100.0) * 60.0 / beta

        def rhs(t, y, beta=beta):
            T = t_ref + beta / 60.0 * t
            r = rates(y, T)
            dy = -r
            dy[1] += nu[1] * r[0]
            dy[2] += nu[2] * r[1]
            return dy

        sol = solve_ivp(rhs, (times[0], times[-1]), [1.0, 0.0, 0.0],
                        method="BDF", t_eval=times, rtol=1e-8, atol=1e-10)
        ys = np.clip(sol.y.T, 0.0, None)
        T = t_ref + beta / 60.0 * sol.t
        r = np.stack([rates(y, temp) for y, temp in zip(ys, T)])
        hrr = r @ del_h
        hrr = hrr * (1.0 + noise * rng.standard_normal(hrr.shape))
        curves.append(np.stack([sol.t, hrr], axis=1))
    return pack_curves(curves, heating_rates)
