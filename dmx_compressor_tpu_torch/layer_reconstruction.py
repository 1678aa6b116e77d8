"""Layer reconstruction: per-module post-training optimization.

Port of ``dmx_compressor_tpu/layer_reconstruction.py``: the per-module
enable / disable plumbing and context managers for

- quantizer (observer) calibration;
- static SmoothQuant calibration, optionally fused into the weight;
- Optimal Brain Compression / GPTQ (arXiv:2208.11580): the Hessian
  accumulated on the module's device in f32 at each forward, the blocked
  Cholesky-inverse update in float64 once, at context exit, on the same
  device (the JAX package runs it in numpy on the host);
- approximation-function tuning (a seeded derivative-free search over the
  surrogate's extra parameters, the same numpy stream as the JAX package's);
- SLaNC norm calibration (analytic, arXiv:2410.10553).
"""

from __future__ import annotations

import copy
import math
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from .functional.approximate import NoApproximation


class LayerReconstructionMixin:
    """Mixed into DmxModule."""

    def update_smoothquant_scale(self, input):
        if self.smoothquant is not None:
            self.smoothquant.observe(input, self.effective_weight)

    # ---------------------------------------------------------- calibration

    def enable_quantizer_calib(self, state: bool, hyperparams) -> None:
        if hyperparams.inputs is not None:
            for k in self.input_casts.keys():
                self.input_casts[k].enable_calibration(state, **vars(hyperparams.inputs[k]))
        if hyperparams.outputs is not None:
            for k in self.output_casts.keys():
                self.output_casts[k].enable_calibration(state, **vars(hyperparams.outputs[k]))
        if getattr(self, "weight", None) is not None:
            if hyperparams.weight is not None:
                self.weight_cast.enable_calibration(state, **vars(hyperparams.weight))
            if hyperparams.weight_storage is not None:
                self.weight_storage_cast.enable_calibration(
                    state, **vars(hyperparams.weight_storage))

    def enable_smoothquant_calib(self, state: bool, hyperparams) -> None:
        if self.smoothquant is not None:
            if self.smoothquant.fused_to_weight:
                raise RuntimeError(
                    "calibrating a SmoothQuant whose scale was already folded into the "
                    "weight would double-apply the migration")
            self.smoothquant.set_migration_strength(hyperparams.migration_strength)
            # the calibration pass is for the static variant
            self.smoothquant.set_dynamic(False)
            self.smoothquant.enable(not state)
            self.smoothquant.calibrating = state
            if not state and hyperparams.fuse_to_weight:
                with torch.no_grad():
                    self.weight.copy_(self.smoothquant.fuse_to_weight(self.weight))

    def enable_optimal_brain_compression(self, state: bool, hyperparams) -> None:
        if getattr(self, "weight", None) is None or self.win_ch_axis is None:
            return
        if state:
            self.obc = OptimalBrainCompressor(self)
            self.input_casts.disable_fake_quant()
            self.weight_cast.disable_fake_quant()
        else:
            self.input_casts.enable_fake_quant()
            self.weight_cast.enable_fake_quant()
            self.obc.apply(**vars(hyperparams))
            self.obc = None

    def enable_approximation_function_tuning(self, state: bool, hyperparams) -> None:
        if not isinstance(self.approximation_function, NoApproximation):
            self.aft = (ApproximationFunctionTuner(self, hyperparams.search_space)
                        if state else None)

    # ------------------------------------------------------ context managers

    @contextmanager
    def calibrating_quantizers(self, hyperparams):
        self.enable_quantizer_calib(True, hyperparams)
        yield self
        self.enable_quantizer_calib(False, hyperparams)

    @contextmanager
    def calibrating_smoothquant(self, hyperparams):
        self.enable_smoothquant_calib(True, hyperparams)
        yield self
        self.enable_smoothquant_calib(False, hyperparams)

    @contextmanager
    def optimal_brain_compressing(self, hyperparams):
        self.enable_optimal_brain_compression(True, hyperparams)
        yield self
        self.enable_optimal_brain_compression(False, hyperparams)

    @contextmanager
    def tuning_approximation_function(self, hyperparams):
        self.enable_approximation_function_tuning(True, hyperparams)
        yield self
        self.enable_approximation_function_tuning(False, hyperparams)

    @contextmanager
    def slanc_tuning(self, hyperparams):
        """The analytic SLaNC norm from the surrounding weights, set on a
        vsimd LayerNorm / RMSNorm surrogate."""
        from .nn import modules as dmxnn

        applicable = (
            isinstance(self, (dmxnn.LayerNorm, dmxnn.RMSNorm))
            and not isinstance(self.approximation_function, NoApproximation)
            and self.approximation_function.algorithm == "vsimd"
        )
        if applicable:
            norm = compute_slanc_norm(hyperparams)
            # an approximation function may be shared across modules: fork ours
            self.approximator.function = copy.deepcopy(self.approximator.function)
            # SLaNC divides the norm's input by `norm`; the surrogate multiplies
            # by its `norm` parameter, hence the reciprocal
            self.approximator.function.extra_params.update({"norm": 1.0 / norm})
        yield self


def _get_weight(mod) -> torch.Tensor:
    """A module's weight (torch Linear layout [out, in]) as f32."""
    return mod.weight.detach().to(torch.float32)


def compute_slanc_norm(hp) -> float:
    """SLaNC's analytic norm for a norm layer at ``hp.position``."""
    if hp.position == "post_attn":
        prev_ln_weight = _get_weight(hp.prev_ln_weight)
        W_V = _get_weight(hp.v_proj)
        P = _get_weight(hp.o_proj)
        if P.shape[1] % W_V.shape[0]:
            raise ValueError(f"o_proj inputs {P.shape[1]} not a multiple of v_proj "
                             f"outputs {W_V.shape[0]}")
        norm = P @ W_V.repeat(P.shape[1] // W_V.shape[0], 1)
        if norm.shape[0] != norm.shape[1]:
            raise ValueError(f"o_proj @ v_proj is not square: {tuple(norm.shape)}")
        norm = norm + torch.eye(norm.shape[0], device=norm.device)
        norm = norm * prev_ln_weight
        return float(torch.linalg.matrix_norm(norm))  # Frobenius
    if hp.position == "post_mlp" and hp.mlp_type == "standard":
        prev_ln_weight = _get_weight(hp.prev_ln_weight)
        A = _get_weight(hp.fc1)
        B = _get_weight(hp.fc2)
        return float(torch.linalg.vector_norm(prev_ln_weight, ord=1)
                     * torch.linalg.matrix_norm(A, ord=2)
                     * torch.linalg.matrix_norm(B, ord=2)
                     / prev_ln_weight.shape[0])
    if hp.position == "post_mlp" and hp.mlp_type == "llama":
        prev_ln_weight = _get_weight(hp.prev_ln_weight)
        W_gate = _get_weight(hp.gate_proj)
        W_up = _get_weight(hp.up_proj)
        W_down = _get_weight(hp.down_proj)
        return float(torch.linalg.matrix_norm(W_down @ (W_up * prev_ln_weight))
                     * torch.linalg.matrix_norm(W_gate * prev_ln_weight, ord=2))
    if hp.position == "first":
        return 1.0
    raise ValueError(f"unknown SLaNC position {hp.position}")


class ApproximationFunctionTuner:
    """Derivative-free tuning of an approximation's extra parameters that
    minimizes the approximation error's mean square: ``n_calls`` evaluations,
    the midpoint first, then uniform exploration, then Gaussian refinement
    around the best point, from ``np.random.default_rng(seed)`` (the JAX
    package's stream, so the candidates are the same)."""

    def __init__(self, module, search_space, n_calls: int = 20, seed: int = 0):
        self.module = module
        self.search_space = [
            (s.name, s.low, s.high) if hasattr(s, "name") else tuple(s) for s in search_space
        ]
        self.n_calls = n_calls
        self.rng = np.random.default_rng(seed)

    def optimize(self, input, *args, **kwargs):
        self.module.approximator.function = copy.deepcopy(self.module.approximator.function)
        module_aft = self.module.aft
        self.module.aft = None  # no recursion through the forward

        def objective(params: dict) -> float:
            self.module.approximator.function.extra_params.update(params)
            with torch.no_grad():
                self.module(input, *args, **kwargs)
            e = self.module.approximation_error
            if isinstance(e, (list, tuple)):
                return float(sum(torch.mean(torch.square(x)) for x in e))
            return float(torch.mean(torch.square(e)))

        names = [n for n, _, _ in self.search_space]
        los = np.array([lo for _, lo, _ in self.search_space], float)
        his = np.array([hi for _, _, hi in self.search_space], float)
        n_explore = max(self.n_calls // 2, 1)
        best_x, best_y = None, float("inf")
        for i in range(self.n_calls):
            if i == 0:
                x = (los + his) / 2
            elif i < n_explore or best_x is None:
                x = self.rng.uniform(los, his)
            else:
                x = np.clip(best_x + self.rng.normal(0, (his - los) / 8), los, his)
            y = objective(dict(zip(names, x)))
            if y < best_y:
                best_x, best_y = x, y
        self.module.aft = module_aft
        self.module.approximator.function.extra_params.update(dict(zip(names, best_x)))


class OptimalBrainCompressor:
    """GPTQ / Optimal Brain Compression of one module's weight."""

    def __init__(self, module):
        self.module = module
        self.example_counter = 0
        self.H: Optional[torch.Tensor] = None

    def measure_hessian(self, inp: torch.Tensor) -> None:
        inp = inp.detach().to(torch.float32)
        if inp.ndim == 2:
            inp = inp[None]
        batch = inp.shape[0]
        if getattr(self.module, "unfold_input_for_hessian", None) is not None:
            inp = self.module.unfold_input_for_hessian(inp)  # the convs' im2col
        else:
            inp = inp.reshape(-1, inp.shape[-1]).T  # [in_features, tokens]
        if self.H is None:
            self.H = torch.zeros((inp.shape[0], inp.shape[0]), dtype=torch.float32,
                                 device=inp.device)
        self.H = self.H * (self.example_counter / (self.example_counter + batch))
        self.example_counter += batch
        inp = math.sqrt(2.0 / self.example_counter) * inp
        self.H = self.H + inp @ inp.T

    @torch.no_grad()
    def apply(self, microblock_size: int = 1, block_size: int = 128, percdamp: float = 0.01):
        """The blocked GPTQ update in float64 (weights and their errors kept in
        f32 between steps, as the JAX package's numpy arrays are); the weight
        pipeline quantizes each microblock."""
        if block_size % microblock_size:
            raise ValueError(f"block_size {block_size} not a multiple of microblock_size "
                             f"{microblock_size}")
        mod = self.module
        sp = mod.weight_sparsifier
        if sp is not None and sp.sparseness.blocked and microblock_size % sp.sparseness.block_size:
            raise ValueError("microblock_size must be a multiple of the sparsity block")
        if mod.weight_cast.format.blocked and microblock_size % mod.weight_cast.format.block_size:
            raise ValueError(f"microblock_size {microblock_size} must be a multiple of the "
                             f"weight format's block {mod.weight_cast.format.block_size}")

        W = mod.weight.detach().to(torch.float32).clone()
        dev = W.device
        orig_shape = W.shape
        if W.ndim > 2:
            W = W.reshape(W.shape[0], -1)
        ncols = W.shape[1]

        H = self.H.to(device=dev, dtype=torch.float64)
        self.H = None
        dead = torch.diag(H) == 0
        H[dead, dead] = 1.0
        W[:, dead] = 0.0
        idx = torch.arange(ncols, device=dev)
        H[idx, idx] += percdamp * torch.mean(torch.diag(H))
        # Hinv: the upper Cholesky factor of H^-1 (GPTQ's flip trick)
        L = torch.linalg.cholesky(H)
        Hinv_full = torch.linalg.inv(L.T) @ torch.linalg.inv(L)
        Hinv = torch.flip(torch.linalg.cholesky(torch.flip(Hinv_full, (0, 1))), (0, 1)).T

        def sub_f32(a32, b64):
            return (a32.to(torch.float64) - b64).to(torch.float32)

        Q = torch.zeros_like(W)
        for i1 in range(0, ncols, block_size):
            i2 = min(i1 + block_size, ncols)
            count = i2 - i1
            _W = W[:, i1:i2].clone()
            _E = torch.zeros_like(_W)
            _Hinv = Hinv[i1:i2, i1:i2]
            for j1 in range(0, count, microblock_size):
                j2 = min(j1 + microblock_size, count)
                w = _W[:, j1:j2]
                q = mod.weight_hypernet(w).to(torch.float32)
                err = (w - q).to(torch.float64) @ torch.linalg.inv(_Hinv[j1:j2, j1:j2])
                Q[:, i1 + j1:i1 + j2] = q
                _W[:, j2:] = sub_f32(_W[:, j2:], err @ _Hinv[j1:j2, j2:])
                _E[:, j1:j2] = err.to(torch.float32)
            W[:, i2:] = sub_f32(W[:, i2:], _E.to(torch.float64) @ Hinv[i1:i2, i2:])
        mod.weight.copy_(Q.reshape(orig_shape).to(mod.weight.dtype))
