"""Share of its roofline that the fused attention forward
(attn_fwd_narrow, csrc/flash_attention.cu) reaches in an SDXL UNet: the
least time of its launches, each at the shape of the self-attention of
the first level that attends (SDXL base 1.0: level 1, B = 2 for CFG, N =
(latent / 2)^2 = 4,096 tokens, 10 heads of 64; level 2's 1,024 tokens
and every cross-attention take the einsum branch, the VAE's 512-wide head
the materialized one), over their device time by kernel name. The least
time is the larger of 4 B H N^2 D operations at the bf16 peak and q, k, v,
o in bf16 at the memory bandwidth. A configuration without per-level
block types (SD v1.5's) reads nothing."""

from benchkit.counts import attention_bytes, attention_flops
from benchkit.device import H100_BF16_FLOPS, least_seconds


def read(rec):
    s = rec.summary
    if s is None or rec.unit != "sds_step":
        return None
    unet = rec.extra["sd"]["unet"]
    if "down_block_types" not in unet:
        return None
    secs, n = s.kernel("attn_fwd_narrow")
    if not n or secs <= 0:
        return None
    level = next(i for i, b in enumerate(unet["down_block_types"])
                 if "CrossAttn" in b)
    H = unet["attention_head_dim"][level]
    D = unet["block_out_channels"][level] // H
    N = (rec.extra["sd"]["latent_size"] >> level) ** 2
    least = least_seconds(attention_flops(2, H, N, D),
                          attention_bytes(2, H, N, D), H100_BF16_FLOPS)
    return 100.0 * n * least / secs
