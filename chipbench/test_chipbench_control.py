"""The control of ``correct`` at each cell's own size, on the card: the
reference computed with TF32 matmuls, put in the program's place, has to
fail one of the cell's limits on every seed, where the program passes
them. Marked ``cuda``: it skips without a card. On the card (about two
minutes a cell and seed):

    PYTHONPATH=src python -m pytest --noconftest -q -p no:cacheprovider \
        -m cuda chipbench/test_chipbench_control.py
"""
import pytest

CELLS = ["mixtral22.decode64", "mixtral22.prefill"]
SEEDS = [4100000001, 4100000002, 4100000003]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    import gc
    import json

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from chipbench import bench, check
    cell = bench.load_cell(name)
    limits = cell["cell"]["check"]["limits"]
    seconds = json.loads((bench.ROOT / "BENCHMARK.json").read_text())[
        "run_seconds"]
    for seed in SEEDS:
        run = bench.Run(cell, seed, seconds, False, "cuda")
        run.build()
        run.serve()
        prog_ok, prog = check.judge(check.program_numbers(run), limits)
        ctl_ok, ctl = check.judge(check.control_numbers(run), limits)
        assert prog_ok, (seed, prog)
        assert not ctl_ok, (seed, ctl)
        del run
        gc.collect()
        torch.cuda.empty_cache()
