"""Hand-written Hopper kernels, their plain PyTorch versions and dispatch.

flash_decode — blocked GQA decode attention (the H(L)*n KV-scan term of
               the paper's decode roofline, §2.2), CUDA C++ in
               csrc/flash_decode.cu;
ref          — the plain versions the kernels are held against;
ops          — the dispatch the model calls.
"""
