"""The paper's own experiment configuration (§V): dataset shapes, block
shapes, chunk ranks, the 1 Gbps object-store latency model.

The port's own copy of ``repro.configs.paper_store`` (plain data)."""

PAPER_STORE = {
    # scenario 1: dense FFHQ-like tensor, FTSF with 3-D chunks
    "dense": {
        "shape": (5000, 3, 1024, 1024),     # paper scale
        "bench_shape": (256, 3, 128, 128),  # CPU-box scale (same structure)
        "chunk_dims": 3,
        "slice": (0, 100),                  # X[0:100] fiber read (Fig. 12)
    },
    # scenario 2: sparse Uber-pickups tensor
    "sparse": {
        "shape": (183, 24, 1140, 1717),
        "bench_shape": (183, 24, 285, 430),  # ~1/16 spatial grid
        "nnz_ratio": 0.00038,                # 0.038% non-zero (paper)
        "bsgs_block": (61, 24, 1, 1),   # time-major blocks: hot cells are
                                         # active across most (day,hour) slots
        "csr_split": 1,
        "slice_dim0": 1,                     # X[i] slice reads (Fig. 16)
    },
    "object_store": {"rtt_s": 0.010, "bandwidth_bps": 1e9},  # paper network
    "repeats": 5,
}
