"""Analytical pieces of the 1/W-law stack that the serving path needs.

Copies of the numpy-only reference modules, trimmed to the H100: chip
(`hardware`), the logistic power curve (`power`), the decode roofline
(`roofline`), the analytical model geometry (`modelspec`), the calibrated
H100 / Llama-3.1-70B profile that meters every engine and the computed
profile (`profiles`), the MoE lever (`moe`) and the workload traces
(`workloads`).
"""
