"""Analytical pieces of the 1/W-law stack that the serving path needs.

Copies of the numpy-only reference modules, trimmed to what the port's
serving layer reads: chips of every generation (`hardware`), their
logistic power curves (`power`), the decode roofline (`roofline`), the
analytical model geometry (`modelspec`), the calibrated H100 /
Llama-3.1-70B profile that meters every engine, its projections on the
other generations and the computed profile (`profiles`), the MoE lever
(`moe`), the workload traces and the diurnal envelope (`workloads`), and
the constants the engine and router take from the fleet layer (`fleet`'s
PREFILL_MFU, `routing`'s detection latency, `topospec`'s semantic kinds).
"""
