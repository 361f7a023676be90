"""Quickstart of the port: the paper's system in 60 lines, on PyTorch.

Store tensors in a delta table under all five formats, read them lazily
through snapshot-pinned TensorRef handles, slice-read without touching most
of the data, read straight onto ``--device`` (``cuda`` by default), batch
writes atomically, and time-travel.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It prints what ``examples/quickstart.py`` prints for the same data.
"""

import argparse

import numpy as np

from ..core import DeltaTensorStore, choose_layout
from ..data.synthetic import uber_like
from ..lake import InMemoryObjectStore, LatencyModel
from ..lake.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device reads (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    lm = LatencyModel()                      # modeled 1 Gbps object store
    store = DeltaTensorStore(InMemoryObjectStore(latency=lm), "tensors",
                             compression="zlib+shuffle",  # chunk-blob codec
                             device=dev)

    # --- dense tensor -> FTSF (the 10% rule picks it automatically) -------
    dense = np.random.default_rng(0).standard_normal((64, 3, 32, 32)).astype(
        np.float32)
    print("policy for dense tensor:", choose_layout(dense))
    store.put(dense, tensor_id="images",                # auto -> ftsf
              target_file_bytes=64 << 10)               # ~12 chunk files

    # --- lazy handle: metadata costs one header read, slicing is numpy ----
    ref = store.open("images")
    print(f"{ref!r}: shape={ref.shape} dtype={ref.dtype} "
          f"stored={ref.nbytes/1e3:.1f} kB in {ref.n_chunk_files} chunk files")

    lm.reset()
    sl = ref[10:14]                                    # 4 of 64 chunks
    print(f"slice read moved {lm.bytes_moved/1e3:.1f} kB "
          f"(full tensor is {dense.nbytes/1e3:.1f} kB)")
    np.testing.assert_array_equal(sl, dense[10:14])
    np.testing.assert_array_equal(ref[0, ..., 16], dense[0, ..., 16])

    fut = ref.read_async()                             # fans out on the executor
    np.testing.assert_array_equal(fut.result(), dense)

    # --- sparse tensor -> every sparse format, one atomic commit ----------
    sparse = uber_like((48, 24, 64, 64), nnz_ratio=0.002)
    print(f"\nsparse tensor: {sparse.shape}, nnz={sparse.nnz} "
          f"({sparse.density:.4%})")
    with store.batch(op="PUT ALL SPARSE FORMATS") as b:
        for layout in ("coo", "csr", "csc", "csf", "bsgs"):
            b.put(sparse, layout=layout, tensor_id=f"pickups-{layout}")
    for layout in ("coo", "csr", "csc", "csf", "bsgs"):
        r = store.open(f"pickups-{layout}")
        print(f"  {layout:5s}: {r.nbytes/1e3:8.1f} kB "
              f"({r.nbytes/(sparse.nnz*40):.2%} of a COO blob) "
              f"coo-native={r.codec.supports_coo}")
        np.testing.assert_array_equal(r.read(), sparse.to_dense())

    # slice read: day 7 only, via block/fiber pushdown
    np.testing.assert_array_equal(store.open("pickups-bsgs")[7:8],
                                  sparse.to_dense()[7:8])

    # --- ACID + time travel -------------------------------------------------
    v = store.version()
    old = store.open("images")                         # pinned at v
    store.put(dense * 2, tensor_id="images", overwrite=True,
              target_file_bytes=64 << 10)   # same chunk-file grid as v1
    np.testing.assert_array_equal(store.open("images").read(), dense * 2)
    np.testing.assert_array_equal(old.read(), dense)   # ref still sees v
    np.testing.assert_array_equal(store.open("images", version=v).read(), dense)
    print(f"\ntime travel: a ref pinned at v{v} still serves the original")
    print("tensors in store:", [t for t, _ in store.list_tensors()])
    print("catalog metadata work:", store.catalog_stats)

    # --- model variants: dedup + delta-encode against a base tensor -------
    # a "fine-tune" that only nudges a slab of the weights: unchanged
    # chunks commit as references to the base's objects (no upload) and
    # changed chunks store as XOR deltas -- reads stay transparent
    variant = (dense * 2).copy()        # current contents of "images"
    variant[:8] *= 1.01                 # ...with 1/8 of the rows nudged
    store.put_variant(variant, base_tid="images", tensor_id="images-ft",
                      target_file_bytes=64 << 10)
    np.testing.assert_array_equal(store.open("images-ft").read(), variant)

    # --- space accounting: logical vs physical bytes, dedup, per codec ----
    st = store.storage_stats()
    print(f"\nstorage: {st['physical_bytes']/1e3:.1f} kB physical / "
          f"{st['logical_bytes']/1e3:.1f} kB logical "
          f"({st['ratio']:.2f}x, default codec {st['compression']!r})")
    d = st["dedup"]
    print(f"dedup: {d['deduped_refs']} of {d['references']} chunk refs "
          f"reused an object ({d['saved_bytes']/1e3:.1f} kB saved), "
          f"{d['delta_files']} variant chunks stored as deltas")

    # --- device reads: FTSF chunk rows staged once and reordered on the
    # device (block_gather), COO pairs scattered there (coo_scatter) -----
    np.testing.assert_array_equal(old.read_device(device=dev).cpu().numpy(),
                                  dense)
    np.testing.assert_array_equal(
        store.get_device("images-ft", [(0, 8)]).cpu().numpy(), variant[:8])
    np.testing.assert_array_equal(
        store.open("pickups-coo").read_device(device=dev).cpu().numpy(),
        sparse.to_dense())


if __name__ == "__main__":
    main()
