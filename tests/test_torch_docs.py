"""Executable documentation of the port: every ```python block of every
page in docs_torch/ runs on the CPU, as tests/test_docs.py runs docs/.

Each page opens with one settings block (the device and the sizes a user
runs on the card); here it is replaced by ``SMALL[page]``: ``DEVICE =
"cpu"`` and small sizes. multi_chip.md runs inside a world of one rank
(``gpx_torch.parallel.mesh.world``)."""

import pathlib
import re

import pytest
import torch

from gpx_torch.parallel.mesh import world

torch.set_num_threads(1)
DOCS = sorted((pathlib.Path(__file__).parent.parent / "docs_torch").glob("*.md"))
SMALL = {
    "index": 'DEVICE, N = "cpu", 300',
    "covariance_functions": 'DEVICE, N, N_ARD, STEPS = "cpu", 128, 24, 20',
    "prediction": 'DEVICE, N, M = "cpu", 300, 200',
    "parameter_inference": 'DEVICE, N, DRAWS, STEPS = "cpu", 30, 10, 10',
    "hamiltonian_monte_carlo": 'DEVICE, N, DRAWS, WARMUP, DEPTH = "cpu", 30, 3, 3, 3',
    "classification": 'DEVICE, N = "cpu", 30',
    "spatial_data": 'DEVICE, N, GRID = "cpu", 30, 10',
    "state_space": 'DEVICE, T, SENSORS, SWEEPS = "cpu", 30, 2, 2',
    "grid_data": 'DEVICE, HOURS, SITES = "cpu", 48, 12',
    "multi_output": 'DEVICE, N, M, STEPS = "cpu", 40, 20, 10',
    "large_n": ('DEVICE, N, N_IT, N_SPARSE, M_SPARSE, STEPS = '
                '"cpu", 256, 512, 500, 20, 10'),
    "multi_chip": 'DEVICE, N = "cpu", 256',
}


def _blocks(path):
    return re.findall(r"```python\n(.*?)```", path.read_text(), flags=re.S)


@pytest.mark.parametrize("doc", DOCS, ids=[d.stem for d in DOCS])
def test_doc_code_runs_on_the_cpu(doc):
    """The page's blocks in order in one namespace, its settings block
    replaced by the small one; a failed assert on the page fails here, and
    every top-level floating tensor it leaves must be finite (as
    chip_smoke.py's phase 11 holds the pages on the card)."""
    assert sorted(SMALL) == sorted(d.stem for d in DOCS)
    blocks = _blocks(doc)
    assert len(blocks) > 1 and blocks[0].startswith("DEVICE"), (
        f"{doc.name} does not open with its settings block")
    ns = {}
    with world("cpu") if doc.stem == "multi_chip" else _nothing():
        for block in [SMALL[doc.stem], *blocks[1:]]:
            exec(compile(block, doc.name, "exec"), ns)
    bad = [k for k, v in ns.items() if isinstance(v, torch.Tensor)
           and v.is_floating_point() and not bool(torch.isfinite(v).all())]
    assert not bad, f"{doc.name}: not finite: {bad}"


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False
