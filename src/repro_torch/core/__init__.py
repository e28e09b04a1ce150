"""Analytical pieces of the 1/W-law stack that the serving path needs.

Copies of the numpy-only reference modules, trimmed to the H100 /
Llama-3.1-70B profile that meters every engine: chip (`hardware`), the
logistic power curve (`power`), the decode roofline (`roofline`), the
analytical model geometry (`modelspec`), the calibrated profile
(`profiles`) and the workload traces (`workloads`).
"""
