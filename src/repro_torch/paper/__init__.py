"""The paper's own experiments on the port (twins of the reference's
``benchmarks/`` scripts of the same names): Table 1 (EF against
Hutchinson's Hessian estimator), Fig. 1 (EF and Hessian block traces
rank alike), Fig. 2 (estimator convergence), Table 2 (FIT against the
heuristics over random mixed-precision configs), Fig. 4 (FIT on
segmentation) and Fig. 5 (the assumption audits). Each module's
``run(device=None)`` emits the reference's CSV lines and returns its
numbers; ``python -m repro_torch.paper.run`` runs them in order."""
