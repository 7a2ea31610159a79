"""The MoE layer's share of its roofline (%): over the profiled steps,
the bytes of the experts each layer's tokens route to (a kept top-k
choice, by the reference's routing of the layer's own input) and of its
input and output, over HBM bandwidth, against the device time of each
layer's call of `models.ffn.moe_apply`, between two timing events the
harness records around it (`cell.MoeTap`; inside the replay where the
step is a CUDA graph, as the benchmark serves it on the card: in an
eager step the interval would also hold the host's gaps between the
layer's launches)."""
import torch

from bench.metrics import arith
from bench.reference import moe_decoder


def read(run):
    tap = run.moe_tap
    if tap is None or not tap.steps or tap.seconds <= 0:
        return None
    m = run.cell.config["model"]
    e, k = m["n_experts"], m["top_k"]
    nbytes = 0
    for router_w, inputs in tap.inputs():
        for x in inputs:
            x2 = x.reshape(-1, x.shape[-1])
            tokens = x2.shape[0]
            group = m["moe_group"] if tokens % m["moe_group"] == 0 \
                else tokens
            _, idx = moe_decoder.route(x2, router_w, k)
            group_of = torch.arange(tokens, device=x2.device) // group
            keep = moe_decoder.keep_mask(idx, group_of, e,
                                         moe_decoder.capacity(
                                             group, k, m["capacity_factor"],
                                             e))
            routed = int(torch.unique(idx[keep]).numel())
            nbytes += arith.moe_bytes(routed, tokens, m["d_model"],
                                      m["d_ff"])
    return 100.0 * nbytes / arith.HBM_BYTES_PER_S / tap.seconds
