"""Hand-written Hopper kernels, their plain PyTorch versions and dispatch.

flash_decode — blocked GQA decode attention (the H(L)*n KV-scan term of
               the paper's decode roofline, §2.2), CUDA C++ in
               csrc/flash_decode.cu;
flash_decode_int8
             — the same attention over an int8 K/V cache (per-(token, head)
               f32 scales, widened in registers), CUDA C++ in
               csrc/flash_decode_int8.cu (the two share
               csrc/decode_common.cuh), and `quantize_kv`, which makes
               such a cache;
mamba_scan   — the Mamba2 chunked SSD scan of a prefill, csrc/mamba_scan.cu;
wkv6         — the RWKV6 chunked recurrence of a prefill, csrc/wkv6.cu;
build        — nvcc build and ctypes loading of the csrc/ sources;
ref          — the plain versions the kernels are held against;
ops          — the dispatch the model calls.
"""
