"""Share of its roofline that the UNet's fused attention forward
(attn_fwd_narrow, csrc/flash_attention.cu) reaches: the least time of
its launches, each at the shape SD v1.5's widths give the UNet's
self-attention at the latent size (B = 2 for CFG, N = latent^2 tokens, H
heads of block_out_channels[0] / H), over their device time by kernel
name. The least time is the larger of 4 B H N^2 D operations at the bf16
peak and q, k, v, o in bf16 at the memory bandwidth."""

from benchkit.counts import attention_bytes, attention_flops
from benchkit.device import H100_BF16_FLOPS, least_seconds


def read(rec):
    s = rec.summary
    if s is None or rec.unit != "sds_step":
        return None
    secs, n = s.kernel("attn_fwd_narrow")
    if not n or secs <= 0:
        return None
    sd = rec.extra["sd"]
    H = sd["unet"]["attention_head_dim"]
    D = sd["unet"]["block_out_channels"][0] // H
    N = sd["latent_size"] ** 2
    least = least_seconds(attention_flops(2, H, N, D),
                          attention_bytes(2, H, N, D), H100_BF16_FLOPS)
    return 100.0 * n * least / secs
