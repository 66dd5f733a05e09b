"""The hub lane's checks on the card beside the CSR kernel's own cases:
row shapes built round its blocks of HUB_CHUNK edges, read by
chip_smoke.py's "kernels against their plain version" phase and by
tests/test_torch_gpu.py."""

# edges a block of the hub lane owns (csr_spmv.cu's kHubChunk)
HUB_CHUNK = 512
E = HUB_CHUNK
# (n_rows, n_cols, mean in-degree, (row, length) overrides)
HUB_CASES = [
    # rows of exactly E edges and of E - 1, E + 1 on block edges, an empty
    # row at a block's edge
    (12, 300, 0.0, ((0, E), (1, E - 1), (2, 1), (3, E + 1), (4, E - 1),
                    (6, E), (7, 2))),
    # a row over 1,000 blocks (ending 3 edges into its last), rows of two
    # blocks exactly and of one block and a few edges, among short ones
    (3000, 4000, 8.0, ((10, 1000 * E + 3), (1500, 2 * E), (2999, E + 7))),
    # every row a block and a half: each block ends inside a row
    (40, 500, 0.0, tuple((r, E + E // 2) for r in range(40))),
]
