"""The legacy explicit fit surface: func_exp_decay1..11, the Lipari-Szabo
product forms and the do_Expstyle_fit / do_LSstyle_fit fits (port of
``spinrelax_tpu/fit/legacy_expfit.py``; the reference's
fitting_Ct_functions.py:483-660).

The same model families, the same per-DoF initial guesses and the same
return contract (chi, params, perr, ymodel) as the JAX package, with the
_bound_check -> 9999.99 sentinel and calc_chi's division by dy (sic, not
dy^2, fitting_Ct_functions.py:547-551).  A single curve or a (B, T) batch
is fitted by one :func:`fit.lm.lm_solve` (its default ``cov="pinv"``) in
place of sequential scipy curve_fit calls.  As in the JAX package,
do_lsstyle_fit implements the intended product-form models (the
reference's func_LS_decay2..9 are commented out, so its own raises
NameError for num_pars >= 2).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import checked_device
from .lm import lm_solve


def _t(x):
    """A tensor as it is; a Python or numpy number or array as float64."""
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, dtype=float))


def _split_params(params, num_pars: int):
    """The reference's flat parameter vector(s) (..., num_pars): odd
    num_pars (S2, A1, tau1, A2, tau2, ...), even (A1, tau1, ...).  Returns
    (S2 (...) or None, amplitudes (..., K), taus (..., K)), K = num_pars // 2
    (num_pars 1: one tau, amplitude 1)."""
    if num_pars == 1:
        return None, torch.ones_like(params[..., :1]), params[..., :1]
    if num_pars % 2 == 1:
        s2, rest = params[..., 0], params[..., 1:]
    else:
        s2, rest = None, params
    return s2, rest[..., 0::2], rest[..., 1::2]


def exp_decay(t, params, num_pars: int):
    """func_exp_decayN (fitting_Ct_functions.py:511-534): a sum of
    exponentials plus S2 (odd DoF) or the implicit 1 - sum(A) (even DoF);
    num_pars 1 is exp(-t/tau).  t () or (T,), params (..., num_pars) ->
    (..., T), or (...) for a scalar t."""
    params = _t(params)
    t = torch.as_tensor(t, dtype=params.dtype, device=params.device)
    scalar = t.ndim == 0
    tv = t.reshape(1) if scalar else t
    s2, amps, taus = _split_params(params, num_pars)
    out = torch.sum(amps[..., None] * torch.exp(-tv / taus[..., None]), dim=-2)
    if num_pars != 1:
        const = s2 if s2 is not None else 1.0 - torch.sum(amps, dim=-1)
        out = const[..., None] + out
    return out[..., 0] if scalar else out


def ls_decay(t, params, num_pars: int):
    """The Lipari-Szabo product forms func_LS_decayN, as the commented-out
    definitions intend (fitting_Ct_functions.py:483-500):
    prod_i (S2_i + (1 - S2_i) exp(-t/tau_i)), times a free S2_0 for odd
    DoF; num_pars 1 is exp(-t/tau).  Shapes as :func:`exp_decay`."""
    params = _t(params)
    t = torch.as_tensor(t, dtype=params.dtype, device=params.device)
    scalar = t.ndim == 0
    tv = t.reshape(1) if scalar else t
    if num_pars == 1:
        out = torch.exp(-tv / params[..., :1])
    else:
        s2_0, amps, taus = _split_params(params, num_pars)
        factors = amps[..., None] + (1.0 - amps[..., None]) * torch.exp(-tv / taus[..., None])
        out = torch.prod(factors, dim=-2)
        if s2_0 is not None:
            out = s2_0[..., None] * out
    return out[..., 0] if scalar else out


def _exp_guess(num_pars: int, t_max: float) -> np.ndarray:
    """Initial guesses of do_Expstyle_fit (fitting_Ct_functions.py:612-655)."""
    g = {
        1: (t_max / 2.0,),
        2: (0.5, t_max / 2.0),
        3: (0.5, 0.5, t_max / 2.0),
        4: (0.33, t_max / 20.0, 0.33, t_max / 2.0),
        5: (0.33, 0.33, t_max / 20.0, 0.33, t_max / 2.0),
        6: (0.25, t_max / 50.0, 0.25, t_max / 10.0, 0.25, t_max / 2.0),
        7: (0.25, 0.25, t_max / 50.0, 0.25, t_max / 10.0, 0.25, t_max / 2.0),
        8: (0.2, t_max / 64.0, 0.2, t_max / 16.0, 0.2, t_max / 4.0, 0.2, t_max),
        9: (0.2, 0.2, t_max / 64.0, 0.2, t_max / 16.0, 0.2, t_max / 4.0, 0.2, t_max),
    }
    return np.asarray(g[num_pars], dtype=float)


def _ls_guess(num_pars: int, t_max: float) -> np.ndarray:
    """Initial guesses of do_LSstyle_fit (fitting_Ct_functions.py:555-610)."""
    g = {
        1: (t_max / 2.0,),
        2: (0.5, t_max / 2.0),
        3: (0.69, 0.69, t_max / 2.0),
        4: (0.69, t_max / 2.0, 0.69, t_max / 20.0),
        5: (0.71, 0.71, t_max / 2.0, 0.71, t_max / 20.0),
        6: (0.71, t_max / 2.0, 0.71, t_max / 8.0, 0.71, t_max / 32.0),
        7: (0.72, 0.72, t_max / 2.0, 0.72, t_max / 8.0, 0.72, t_max / 32.0),
        8: (0.72, t_max, 0.72, t_max / 4.0, 0.72, t_max / 16.0, 0.72, t_max / 64.0),
        9: (0.74, 0.74, t_max, 0.74, t_max / 4.0, 0.74, t_max / 16.0, 0.74, t_max / 64.0),
    }
    return np.asarray(g[num_pars], dtype=float)


def bound_check(params, num_pars: int) -> np.ndarray:
    """_bound_check (fitting_Ct_functions.py:536-545): True where the
    amplitude sum (plus the explicit S2 for odd DoF) exceeds 1."""
    params = np.atleast_2d(np.asarray(params))
    if num_pars == 1:
        return np.zeros(params.shape[0], dtype=bool)
    if num_pars % 2 == 0:
        s = params[:, 0::2].sum(axis=1)
    else:
        s = params[:, 0] + params[:, 1::2].sum(axis=1)
    return s > 1.0


def calc_chi(y, ymodel, dy=None):
    """The reference's chi (fitting_Ct_functions.py:547-551): the mean
    squared residual divided by dy -- sic, not dy^2.  dy None or empty
    (the reference's default ``dy=[]``) is unweighted."""
    y = np.asarray(y)
    ymodel = np.asarray(ymodel)
    sq = (y - ymodel) ** 2.0
    if dy is not None and np.asarray(dy).size:
        sq = sq / np.asarray(dy)
    return np.sum(sq, axis=-1) / y.shape[-1]


def _fit_family(model_fn, guess_fn, num_pars: int, x, y, dy=None,
                tau_cap_factor: float = 1e3, device="cuda"):
    """One bounded :func:`lm_solve` over the per-DoF guess table for a
    curve (T,) or a batch (B, T).  Amplitudes and S2 are boxed in [0, 1];
    the reference's taus are unbounded above, the sigmoid box caps them at
    ``tau_cap_factor`` t_max.  Tensor y keeps its device and dtype; numpy y
    goes to ``device`` in float64.  Returns numpy (chi (B,), params (B, P),
    perr (B, P), ymodel (B, T)), unbatched for a 1-D y."""
    if torch.is_tensor(y):
        yb = y
    else:
        yb = torch.as_tensor(np.asarray(y, dtype=float), device=checked_device(device))
    single = yb.ndim == 1
    yb = torch.atleast_2d(yb)
    dev, f = yb.device, yb.dtype
    empty = dy is None or (hasattr(dy, "__len__") and len(dy) == 0)
    xt = torch.as_tensor(np.asarray(x.cpu() if torch.is_tensor(x) else x, dtype=float),
                         dtype=f, device=dev)
    t_max = float(xt[-1])
    p0 = guess_fn(num_pars, t_max)
    lo = np.zeros(num_pars)
    hi = np.ones(num_pars)
    if num_pars == 1:
        tau_idx = np.array([0])
    elif num_pars % 2 == 0:
        tau_idx = np.arange(1, num_pars, 2)
    else:
        tau_idx = np.arange(2, num_pars, 2)
    lo[tau_idx] = 1e-8
    hi[tau_idx] = tau_cap_factor * t_max
    # a single (T,) sigma is shared by every curve of the batch
    sg = torch.ones_like(yb) if empty else torch.as_tensor(
        dy, dtype=f, device=dev).broadcast_to(yb.shape)
    B = yb.shape[0]
    res = lm_solve(lambda p: (model_fn(xt, p, num_pars) - yb) / sg,
                   torch.as_tensor(p0, dtype=f, device=dev).expand(B, num_pars),
                   torch.as_tensor(lo, dtype=f, device=dev),
                   torch.as_tensor(hi, dtype=f, device=dev))
    params = res.params.cpu().numpy()
    perr = res.perr.cpu().numpy()
    ymodel = model_fn(xt, res.params, num_pars).cpu().numpy()
    chi = calc_chi(yb.cpu().numpy(), ymodel, None if empty else sg.cpu().numpy())
    # _bound_check -> 9999.99 sentinel (fitting_Ct_functions.py:621-627)
    chi = np.where(bound_check(params, num_pars), 9999.99, chi)
    if single:
        return float(chi[0]), params[0], perr[0], ymodel[0]
    return chi, params, perr, ymodel


def do_expstyle_fit(num_pars: int, x, y, dy=None, device="cuda"):
    """do_Expstyle_fit (fitting_Ct_functions.py:612-660) for y (T,) or a
    batch (B, T) in one LM.  Returns (chi, params, perr, ymodel) as numpy.
    Runs on the card unless ``device="cpu"`` (a tensor y keeps its own)."""
    if not 1 <= num_pars <= 9:
        raise ValueError(f"num_pars must be in 1..9, got {num_pars}")
    return _fit_family(exp_decay, _exp_guess, num_pars, x, y, dy, device=device)


def do_lsstyle_fit(num_pars: int, x, y, dy=None, device="cuda"):
    """do_LSstyle_fit (fitting_Ct_functions.py:555-610) with the intended
    Lipari-Szabo product models (module docstring); as
    :func:`do_expstyle_fit`."""
    if not 1 <= num_pars <= 9:
        raise ValueError(f"num_pars must be in 1..9, got {num_pars}")
    return _fit_family(ls_decay, _ls_guess, num_pars, x, y, dy, device=device)


def _make_named(num_pars):
    def f(t, *params):
        return exp_decay(np.asarray(t, dtype=float), np.asarray(params, dtype=float),
                         num_pars).numpy()

    f.__name__ = f"func_exp_decay{num_pars}"
    f.__doc__ = (f"func_exp_decay{num_pars}(t, *params) of the reference, as numpy "
                 f"(float64, on the CPU).")
    return f


# The reference's numbered family (10 and 11 are its 5-term members,
# fitting_Ct_functions.py:520-534).
_NUMBERED = {n: _make_named(n) for n in range(1, 12)}
func_exp_decay1 = _NUMBERED[1]
func_exp_decay2 = _NUMBERED[2]
func_exp_decay3 = _NUMBERED[3]
func_exp_decay4 = _NUMBERED[4]
func_exp_decay5 = _NUMBERED[5]
func_exp_decay6 = _NUMBERED[6]
func_exp_decay7 = _NUMBERED[7]
func_exp_decay8 = _NUMBERED[8]
func_exp_decay9 = _NUMBERED[9]
func_exp_decay10 = _NUMBERED[10]
func_exp_decay11 = _NUMBERED[11]
