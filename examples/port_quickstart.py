"""Quickstart on the PyTorch port: the 1/W law in five minutes.

Reproduces paper Table 1 (tok/W halves per context-window doubling),
fits the law, and runs the Appendix-B fleet analyzer on the Azure trace,
through `repro_torch.core` (host numpy; it prints what
examples/quickstart.py prints).

  PYTHONPATH=src python examples/port_quickstart.py
"""
from repro_torch.core import (AZURE, B200_LLAMA70B, H100_LLAMA70B,
                              context_sweep, fit_one_over_w,
                              fleet_tpw_analysis)


def main():
    print("=== The 1/W law (paper Table 1) ===")
    print(f"{'ctx':>6} | {'H100 n_max':>10} {'tok/W':>7} | "
          f"{'B200 n_max':>10} {'tok/W':>7}")
    for rh, rb in zip(context_sweep(H100_LLAMA70B),
                      context_sweep(B200_LLAMA70B)):
        print(f"{rh.context // 1024:>5}K | {rh.n_max:>10} "
              f"{rh.tok_per_watt:>7.2f} | {rb.n_max:>10} "
              f"{rb.tok_per_watt:>7.2f}")
    fit = fit_one_over_w(H100_LLAMA70B)
    print(f"\nlog2(tok/W) ~ {fit.slope:.2f} * log2(W)  (law predicts -1; "
          f"idle power bends the tail)")
    print("per-doubling ratios:",
          [round(r, 2) for r in fit.halving_ratios])

    print("\n=== Fleet topology analysis (Appendix B API, Azure trace) ===")
    res = fleet_tpw_analysis(workload=AZURE, profile=H100_LLAMA70B,
                             b_short=4096)
    for row in res.table():
        print(" ", row)
    print(f"gamma* = {res.gamma_star}")


if __name__ == "__main__":
    main()
