"""Toy sizes at which the tests drive each driver's cells on the CPU.

The LM cells' toy model runs in float32: at widths of 64 the bfloat16
program's gaps to the float32 reference are those of a toy model, not of
the cell's widths that its limits were set at; in float32 the sound
program reads far under them and the control, in fp8, far over."""

TOYS = {
    "linear_runs": {"config": {"nodes": 8, "n": 256, "total_samples": 8 * 40},
                    "workload": {"params": {"chunk_rounds": 16}}},
    "lm_train": {"config": {"num_layers": 2, "d_model": 64, "num_heads": 4,
                            "num_kv_heads": 4, "head_dim": 16, "d_ff": 128,
                            "vocab_size": 300, "dtype": "float32"},
                 "workload": {"params": {"seq_len": 16, "pool_steps": 8}}},
}


def toy(harness, cell: str) -> dict:
    files = harness.cell_files(harness.load_manifest(), cell)
    return TOYS[files["workload"]["driver"]]
