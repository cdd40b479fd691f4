"""The rmsnorm forward kernel's launch geometry
(``repro_torch.kernels.rmsnorm.layout``), walked on the CPU as the kernel
walks it: every row gets exactly one row group, the group's threads own
every column of the row once, chunks a thread stay within the kernel's
register budget, rows wider than that budget take the wide path, and fewer
rows than SMs, or too few to fill them with row groups, get at least a
whole block a row.  The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``)."""

import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import rmsnorm as RMS  # noqa: E402

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "rmsnorm.cu")

#: the training call (4 x 2048 rows of 3,072), the prefill's gated norm
#: (8 x 2048 of 7,168), decode (8 rows of 3,584 and 7,168), qwen3's QK-norm
#: (4 x 2048 x 32 heads of 128), and the edges: D = 100 (over a block a
#: row and over sub-warp groups) and odd D, a row count that is no multiple
#: of the groups a block, one row short of and at the SM count, the most
#: rows that leave an SM idle on the row path and one more (524 and 525
#: rows of 3,072 bf16, four a block), 256 decode slots, the widest bf16 row
#: the registers hold (12,288) and rows beyond it
SHAPES = [(8192, 3072), (16384, 7168), (8, 3584), (8, 7168), (262144, 128),
          (51, 100), (1000, 100), (20000, 100), (300, 4097), (1001, 3072),
          (131, 3072), (132, 3072), (524, 3072), (525, 3072), (256, 3584),
          (1, 1), (300, 12288), (300, 16384), (3, 20000), (300, 20000)]


def walked_rows(lay, rows):
    """Each row as many times as the kernel normalises it: on the row and
    few-rows paths group g of block b takes row b * groups + g (if there is
    one); on the wide path block b walks rows b, b + grid, ..."""
    if lay.path == "wide":
        return np.concatenate([np.arange(b, rows, lay.grid)
                               for b in range(lay.grid)])
    taken = np.arange(lay.grid * lay.groups)
    return taken[taken < rows]


def owned_columns(lay, D):
    """The columns a group's threads hold: thread t owns chunks c * tpr + t
    (c < nv) of ``vec`` elements each; the wide path's block walks chunks
    t, t + threads, ... up to the row's end."""
    if lay.path == "wide":
        chunks = np.arange(-(-D // lay.vec))
    else:
        chunks = (np.arange(lay.nv)[:, None] * lay.tpr
                  + np.arange(lay.tpr)[None, :]).ravel()
    cols = (chunks[:, None] * lay.vec + np.arange(lay.vec)[None, :]).ravel()
    return cols[cols < D]


@pytest.mark.parametrize("rows,D", SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_every_row_gets_one_group_that_covers_it(rows, D, itemsize):
    lay = RMS.layout(rows, D, itemsize)
    assert lay.vec * itemsize == 16 and lay.grid >= 1
    assert np.array_equal(np.sort(walked_rows(lay, rows)), np.arange(rows))
    assert np.array_equal(np.sort(owned_columns(lay, D)), np.arange(D))


@pytest.mark.parametrize("rows,D", SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_the_geometry_is_one_the_kernel_takes(rows, D, itemsize):
    lay = RMS.layout(rows, D, itemsize)
    chunks = -(-D // lay.vec)
    if lay.path == "wide":
        assert chunks > RMS.MAX_CHUNKS * RMS.ROW_THREADS
        assert (lay.nv, lay.threads) == (0, RMS.WIDE_THREADS)
        return
    assert chunks <= RMS.MAX_CHUNKS * RMS.ROW_THREADS
    assert 1 <= lay.nv <= RMS.MAX_CHUNKS          # the register budget
    assert lay.nv * lay.tpr * lay.vec >= D
    assert lay.threads <= RMS.ROW_THREADS and lay.threads % 32 == 0
    assert lay.threads % lay.tpr == 0
    if lay.tpr < 32:
        assert lay.tpr & (lay.tpr - 1) == 0        # shuffles within a warp
    else:
        assert lay.tpr % 32 == 0 and lay.groups <= 8   # named barriers 1..8
    fewest = fewest_threads(chunks)
    if rows < RMS.SMS:
        assert lay.path == "few"
    if lay.path == "few":                          # a whole block a row
        assert -(-rows // (RMS.ROW_THREADS // fewest)) < RMS.SMS
        assert lay.groups == 1 and lay.grid == rows
        assert lay.threads >= min(32 * -(-chunks // 32), RMS.ROW_THREADS)
    else:                                          # the fewest threads a row
        assert lay.path == "rows" and lay.tpr == fewest
        assert lay.grid >= RMS.SMS


def fewest_threads(chunks):
    """The fewest threads, a power of two up to a warp or a multiple of 32
    above, that hold ``chunks`` chunks in at most MAX_CHUNKS each."""
    tpr = 1
    while -(-chunks // tpr) > RMS.MAX_CHUNKS:
        tpr = tpr * 2 if tpr < 32 else tpr + 32
    return tpr


def test_a_row_group_grid_that_leaves_sms_idle_takes_a_block_a_row():
    """At 3,072 bf16 the row path puts four groups of 128 in a block: up
    to 524 rows it would leave an SM idle, so every row gets a block of
    its own; from 525 the row path's 132 blocks cover the SMs."""
    L = RMS.layout
    for rows in (131, 132, 256, 524):
        assert L(rows, 3072, 2) == RMS.Layout("few", 384, 384, rows, 1, 8)
    assert L(525, 3072, 2) == RMS.Layout("rows", 128, 512, 132, 3, 8)
    assert L(256, 3584, 2) == RMS.Layout("few", 448, 448, 256, 1, 8)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_rows_wider_than_the_registers_take_the_wide_path(itemsize):
    widest = RMS.MAX_CHUNKS * RMS.ROW_THREADS * (16 // itemsize)
    assert RMS.layout(1000, widest, itemsize).path == "rows"
    assert RMS.layout(8, widest, itemsize).path == "few"
    for rows in (8, 1000):
        assert RMS.layout(rows, widest + 1, itemsize).path == "wide"


def test_the_main_paths_geometry():
    """Pinned at the calls of the main paths (bf16)."""
    L = RMS.layout
    assert L(8192, 3072, 2) == RMS.Layout("rows", 128, 512, 2048, 3, 8)
    assert L(16384, 7168, 2) == RMS.Layout("rows", 320, 320, 16384, 3, 8)
    assert L(8, 3584, 2) == RMS.Layout("few", 448, 448, 8, 1, 8)
    assert L(8, 7168, 2) == RMS.Layout("few", 512, 512, 8, 2, 8)
    assert L(262144, 128, 2) == RMS.Layout("rows", 8, 512, 4096, 2, 8)


def test_the_constants_match_the_kernel_source():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kMaxFwdChunks") == RMS.MAX_CHUNKS
    assert const("kFwdThreads") == RMS.ROW_THREADS
    assert const("kWideThreads") == RMS.WIDE_THREADS
