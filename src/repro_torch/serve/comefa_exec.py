"""Execute decode-step projections on the CoMeFa grid.

With ``cfg.quant_bits`` set, `models.common.linear` stores w-bit
bit-plane packed weights.  `GridLinearExecutor` is a
`models.common.set_linear_hook` interceptor that runs each packed
projection on a `ComefaGrid` via `kernels.comefa_sim.comefa_gemv_batched`,
one decode request per grid slot (batches wider than the grid take
multiple waves; `active_mask` lets the continuous batcher skip retired
slots).  The grid lives on the weights' device, so on a CUDA device
every chunk runs the CUDA step kernel unless another engine is named.

The grid kernels take **unsigned** operands, so both sides are
offset-encoded around their zero points and corrected on the host:

    q_w in [-2^(w-1), 2^(w-1)-1]   ->  w_u = q_w + 2^(w-1)
    q_x in [-2^(x-1), 2^(x-1)-1]   ->  x_u = q_x + 2^(x-1)

    q_w.T q_x = w_u.T x_u - b_w * sum_k x_u - b_x * sum_k w_u
                + K * b_w * b_x          (b_w = 2^(w-1), b_x = 2^(x-1))

Activations are quantized per request row (symmetric, `x_bits`, in
float32 numpy on the host, rounding half to even as `np.rint` does); the
final dequantize multiplies the integer accumulator by
``scale_w * scale_x`` in float32.  ``backend="reference"`` replaces ONLY
the integer GEMV - with an exact float64 product on the activations'
device - and every other op (quantize, offsets, corrections, dequantize)
is the same code path, so grid-executed outputs are required to be
bit-exact against the reference, which is what the tests pin.

``recode=None`` dispatches the value-independent broadcast program;
``"naive" | "booth" | "naf"`` uses `ComefaGrid.run_per_slot` per-slot
digit-stream specialization - each slot's FSM streams its own recoded
activation digits.  ``"auto"`` hands the choice to
`core.comefa.recode.select_wave` per wave/slot/chunk.  The
``REPRO_TORCH_COMEFA_RECODE`` environment variable overrides the default
for whole sweeps without touching call sites.

The grid backend keeps, per projection, only the weights in the grid's
packed row layout on the device (`comefa_sim.StagedWeights`, about one
byte per 8-bit weight) and the column sums on the host; no unpacked
integer copy of a weight matrix is held.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.comefa.isa import ceil_log2
from ..kernels import comefa_sim
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..quant import bitplane

_GRID_WAVES = obs_metrics.counter("serve.grid_waves")
_GRID_OCCUPANCY = obs_metrics.gauge("serve.grid_occupancy")

ENV_RECODE = "REPRO_TORCH_COMEFA_RECODE"


def _resolve_recode(recode):
    """Apply the ``REPRO_TORCH_COMEFA_RECODE`` override to the default.

    An explicit constructor argument (including ``None``) always wins;
    only the ``"env"`` sentinel default consults the environment.
    ``none``/``broadcast`` map to the shared broadcast program, ``auto``
    to per-wave adaptive selection, the rest to fixed per-slot digit
    schedules; unset keeps the broadcast default.
    """
    if recode != "env":
        return recode
    val = os.environ.get(ENV_RECODE, "").strip().lower()
    if val in ("", "none", "broadcast"):
        return None
    if val in ("auto", "naive", "booth", "naf"):
        return val
    raise ValueError(
        f"{ENV_RECODE}={val!r}: expected one of "
        f"none|broadcast|auto|naive|booth|naf")


def acc_bits_for(w_bits: int, x_bits: int, k: int) -> int:
    """Accumulator width covering the worst-case unsigned dot product.

    max(w_u.T x_u) = (2^w - 1)(2^x - 1) * K < 2^(w + x + ceil_log2(K)).
    """
    return w_bits + x_bits + ceil_log2(max(2, k))


def _offset_weights(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed planes -> unsigned offset weights ``[K, N]`` int32."""
    return bitplane.unpack(packed, bits, axis=0) + (1 << (bits - 1))


class GridLinearExecutor:
    """Route packed-projection GEMVs through the CoMeFa grid.

    Install with ``models.common.set_linear_hook(executor)`` (the serving
    engine does this for the duration of one generate / serve call).

    Parameters
    ----------
    slots: grid width G - decode requests per dispatch wave.
    x_bits: activation quantization width (weights carry their own width
        in ``packed.shape[0]``).
    recode: None for the shared broadcast program, "naive"/"booth"/
        "naf" for a fixed per-slot digit-stream specialization, or
        "auto" for per-wave/per-slot/per-chunk adaptive selection
        (`core.comefa.recode`).  The default ``"env"`` sentinel reads
        the ``REPRO_TORCH_COMEFA_RECODE`` environment override (falling
        back to the broadcast program when unset).
    backend: "grid" executes on the bit-level simulator; "reference"
        swaps ONLY the integer GEMV for an exact product (the bit-exact
        oracle the tests compare against).
    engine: forwarded to the simulator; None follows the weights'
        device (``cuda`` on a CUDA device, ``reference`` on the CPU).
    """

    def __init__(self, slots: int = 4, x_bits: int = 8,
                 recode: Optional[str] = "env", backend: str = "grid",
                 engine=None):
        assert backend in ("grid", "reference"), backend
        self.slots = slots
        self.x_bits = x_bits
        self.recode = _resolve_recode(recode)
        self.backend = backend
        self.engine = engine
        # continuous batching: bool [rows] marking live requests; None
        # means every row is live (plain generate)
        self.active_mask: Optional[np.ndarray] = None
        # occupancy accounting: live slots dispatched / slot capacity
        self.slot_steps = 0
        self.slot_capacity = 0
        self.calls = 0
        self.grid_cycles = 0
        self._wcache: Dict[int, tuple] = {}

    # -- weights -----------------------------------------------------------
    def _weights(self, packed: torch.Tensor, bits: int):
        """Per-column sums of the offset weights (host int64 ``[N]``) and,
        for the grid backend, the weights staged in the grid's row layout
        on the device - built once per projection (keyed on the packed
        tensor's identity; params do not change across decode steps)."""
        key = id(packed)
        ent = self._wcache.get(key)
        if ent is None or ent[0] is not packed:
            w_u = _offset_weights(packed, bits)
            col_sum = w_u.sum(dim=0, dtype=torch.int64).cpu().numpy()
            staged = (comefa_sim.stage_weights(w_u, bits, packed.device)
                      if self.backend == "grid" else None)
            ent = (packed, col_sum, staged)
            self._wcache[key] = ent
        return ent[1], ent[2]

    # -- stats -------------------------------------------------------------
    def occupancy(self) -> float:
        """Mean fraction of grid slots carrying a live request."""
        if not self.slot_capacity:
            return 0.0
        return self.slot_steps / self.slot_capacity

    # -- the hook ----------------------------------------------------------
    def __call__(self, params, x2: torch.Tensor, bits: int) -> torch.Tensor:
        """hook(params, x2 [rows, K], bits) -> [rows, N] float32 on x2's
        device."""
        packed, scale = params["packed"], params["scale"]
        col_sum, staged = self._weights(packed, bits)
        k, n = packed.shape[1] * bitplane.LANES, packed.shape[2]
        xf = x2.detach().to(torch.float32).cpu().numpy()
        rows = xf.shape[0]
        # per-row symmetric activation quantization (mirrors
        # bitplane.quantize, including the -qmax-1 clip edge)
        qmax = float(2 ** (self.x_bits - 1) - 1)
        absmax = np.abs(xf).max(axis=1)
        s_x = np.where(absmax > 0, absmax / qmax, 1.0).astype(np.float32)
        q_x = np.clip(np.rint(xf / s_x[:, None]), -qmax - 1, qmax)
        b_w = 1 << (bits - 1)
        b_x = 1 << (self.x_bits - 1)
        x_u = q_x.astype(np.int64) + b_x                   # in [0, 2^x)
        if self.active_mask is None:
            live = np.arange(rows)
        else:
            live = np.flatnonzero(np.asarray(self.active_mask, bool))
        acc_bits = acc_bits_for(bits, self.x_bits, k)
        acc = np.zeros((rows, n), np.int64)
        self.calls += 1
        with obs_trace.span("serve.grid_linear", rows=rows, k=k, n=n,
                            backend=self.backend) as sp:
            for start in range(0, len(live), self.slots):
                wave = live[start:start + self.slots]
                g = len(wave)
                self.slot_steps += g
                self.slot_capacity += self.slots
                _GRID_WAVES.inc(backend=self.backend)
                if self.backend == "grid":
                    stats: Dict = {}
                    acc[wave] = comefa_sim.comefa_gemv_batched(
                        staged, x_u[wave], w_bits=bits, x_bits=self.x_bits,
                        acc_bits=acc_bits, recode=self.recode, stats=stats,
                        engine=self.engine, device=packed.device)
                    self.grid_cycles += stats["cycles"]
                else:
                    acc[wave] = self._reference_gemv(packed, bits,
                                                     x_u[wave])
            sp.set(waves=-(-len(live) // self.slots) if len(live) else 0)
        _GRID_OCCUPANCY.set(self.occupancy(), backend=self.backend)
        # zero-point corrections recover the signed accumulator, then
        # dequantize: y = (q_w.T q_x) * scale_w * scale_x
        acc_q = (acc - b_w * x_u.sum(axis=1)[:, None]
                 - b_x * col_sum[None, :] + k * b_w * b_x)
        scale_w = scale.detach().to(torch.float32).cpu().numpy().reshape(
            1, -1)
        y = acc_q.astype(np.float32) * (scale_w * s_x[:, None])
        return torch.as_tensor(y, device=x2.device)

    def _reference_gemv(self, packed: torch.Tensor, bits: int,
                        x_u: np.ndarray) -> np.ndarray:
        """x_u [g, K] @ w_u [K, N] exactly, on the weights' device.

        Every product and partial sum is an integer below
        (2^w - 1)(2^x - 1) K < 2^53, so float64 sums them exactly in any
        order (CUDA has no int64 matrix product).
        """
        k = packed.shape[1] * bitplane.LANES
        assert ((1 << bits) - 1) * ((1 << self.x_bits) - 1) * k < 2 ** 53
        w_u = _offset_weights(packed, bits).to(torch.float64)
        xt = torch.as_tensor(x_u, dtype=torch.float64, device=packed.device)
        return (xt @ w_u).cpu().numpy().astype(np.int64)
