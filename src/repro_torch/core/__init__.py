"""Core of the port: the paper's analytical memory model on torch tensors.

    fpga        -- DRAM/BSP parameter classes (values: repro_torch.hw)
    lsu         -- LSU taxonomy (Table I) and descriptors (Table II)
    model       -- scalar reference of Eqs. 1-10 (the ``scalar`` backend)
    model_batch -- the same equations over float64 tensors (``torch``)
    apps        -- SIV microbenchmarks + Table IV applications
    sweep       -- materialized design-space sweeps + Pareto fronts
    stream      -- streaming sweeps: grid enumerator, mergeable reducers,
                   the picklable SweepPlan
    device_stream -- the streaming fold on the device (CUDA graph on a card)
    distributed -- the spawn-based coordinator/worker process pool
    validate    -- measured-vs-predicted loop over the CUDA kernels
    cache       -- content-hash keys, the in-memory LRU, on-disk HLO records
    serving     -- the micro-batching, LRU-cached query server
    hbm         -- TPU-model access classes and the HBM traffic model
    hlo         -- shapes, collectives and opcode classes of HLO text
    hlo_counter -- trip-count-aware FLOP/byte counts of HLO text
    predictor   -- step-time prediction from compiled HLO text
    roofline    -- three-term roofline cells
    dramsim     -- the event-driven DRAM simulator (the validation oracle)
    baselines   -- the Wang and HLScope+ models of the paper's Table V

Imports nothing at package level: ``repro_torch.hw`` reads ``fpga`` and
``hbm`` from here while it is itself still loading.
"""
