"""Kernel names a layer's metrics read from the trace: the port's own
kernels and the PyTorch library's kernels that could stand in for them, so
that a change which replaces one still reads the same work."""

# Attention forward: K1 and K2 (`attn_sm90::attention_kernel<PackedLoader |
# StridedLoader>`), PyTorch's flash, memory-efficient and cuDNN SDPA.
ATTENTION_FWD = ("attn_sm90::attention_kernel", "flash_fwd", "fmha_cutlassF",
                 "attention_forward", "fmha_fwd", "cudnn_generated_fort_native_sdpa_sm90_flash_fprop")
ATTENTION_FWD_NOT = ("bwd", "backward")
# Attention backward: the dQ and dK/dV kernels (`attn_bwd::dq_kernel`,
# `attn_bwd::dkdv_kernel`), PyTorch's flash and memory-efficient backward.
ATTENTION_BWD = ("attn_bwd::dq_kernel", "attn_bwd::dkdv_kernel", "flash_bwd", "fmha_cutlassB",
                 "attention_backward", "fmha_bwd", "sdpa_sm90_flash_bprop")
