"""Core of the port: the paper's analytical memory model on torch tensors.

    fpga        -- DRAM/BSP parameter classes (values: repro_torch.hw)
    lsu         -- LSU taxonomy (Table I) and descriptors (Table II)
    model       -- scalar reference of Eqs. 1-10 (the ``scalar`` backend)
    model_batch -- the same equations over float64 tensors (``torch``)
    apps        -- SIV microbenchmarks + Table IV applications
    sweep       -- materialized design-space sweeps + Pareto fronts
    validate    -- measured-vs-predicted loop over the CUDA kernels

Imports nothing at package level: ``repro_torch.hw`` reads ``fpga`` and
``hbm`` from here while it is itself still loading.
"""
