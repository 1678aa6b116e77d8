"""Per-layer metric readers, one file each (``metrics/<name>.py``, loaded by
path): ``read(trace)`` returns the metric's value from a traced run
(``trace.Trace``), or None where it finds nothing to read.  The kernels of
each layer, by the names their CUDA sources give them:"""

LINEAR_KERNELS = ("bfp_wgmma_kernel", "split_planes_kernel", "bfp_decode_kernel",
                  "bfp_bf16_ragged_kernel", "bfp_gemm_kernel")
ATTENTION_KERNELS = ("flash_attention_kernel", "flash_attention_wide_kernel",
                     "flash_attention_generic_kernel")


def roofline(trace, layer: str, kernels) -> "float | None":
    """100 x the Σ of the layer's bounds (``work/``) over its kernels' device
    time, as measured; None where the window ran no such work or kernel.  A
    share above 100 % is a lost reading that ``run.py`` takes again."""
    bound, dev = trace.work.get(layer), trace.device_s(*kernels)
    if not bound or dev <= 0:
        return None
    return 100.0 * bound / dev


def mfu(trace) -> "float | None":
    from ..work import PEAK_FLOP_S

    flops = trace.work.get("model_flops")
    return 100.0 * flops / (trace.window_s * PEAK_FLOP_S) if flops else None


def idle(trace) -> "float | None":
    if not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
