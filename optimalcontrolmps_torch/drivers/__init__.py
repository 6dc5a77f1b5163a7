"""The reference's executables, on the port:

  optimize_ramp          <- main/OptimizeRamp.cpp      (GROUP/GRAPE, IPOPT)
  amoeba_opt             <- main/AmoebaOpt.cpp         (Nelder-Mead)
  test_runtimes          <- main/TestRuntimes.cpp      (runtime tables)
  analyze_bond_dim       <- main/AnalyzeBondDim.cpp
  analyze_quench         <- main/AnalyzeQuench.cpp
  calculate_defects      <- main/CalculateDefects.cpp
  extend_time_evolution  <- main/ExtendTimeEvolution.cpp
  prep_states            boundary ground states, cached in an npz
  scaling_bench          weak scaling over 1/2/4/8 ranks (torchrun)

Each runs as `python -m optimalcontrolmps_torch.drivers.<name> ...` with
the reference's positional arguments (InputFile, optional seed or ramp
file), on the card unless the InputFile says `backend = cpu`.
"""
