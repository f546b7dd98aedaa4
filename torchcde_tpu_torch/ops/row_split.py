"""How the row kernels of K4, K5 and K6/K7 lay a row out on the card, as
``csrc/row_scan.cuh`` does: each row resident in the registers of a power
of two of threads up to ``RESIDENT_MAX`` positions; past it, split into
segments of at most ``RESIDENT_MAX`` positions, one block each, over a
thread block cluster up to ``CLUSTER_REACH`` and in launches of their own
beyond, the scans' totals crossing through device memory.

* ``threads_per_row(k)``: the threads of a resident row;
* ``row_split(k)``: the segments of a longer row and the positions each
  holds (the callers check the range their route takes);
* ``row_plan(k)``: the launch of a solve's rows of length k, as
  ``SolvePlan``;
* ``segment_totals(segments, n, shared_pivots)``: the size of a segmented
  solve's totals buffer (K4's and K5's); ``fit_totals(segments, n)`` the
  same for K6/K7's segmented fit.
"""

from typing import NamedTuple

# The resident rows' shape (csrc/row_scan.cuh: RP, RT, RES_MAX,
# CLUSTER_MAX); the kernels' libraries check it when they load.
POSITIONS = 16         # positions a thread holds
BLOCK_THREADS = 256    # threads per block
RESIDENT_MAX = POSITIONS * BLOCK_THREADS
CLUSTER_MAX = 8        # blocks a row's cluster spans at most (the portable cluster size)
CLUSTER_REACH = CLUSTER_MAX * RESIDENT_MAX  # the longest row a cluster holds


class SolvePlan(NamedTuple):
    variant: str          # the route
    threads_per_row: int  # (over a cluster or segmented: the threads of a block's segment)
    rows_per_block: int
    threads: int          # per block
    positions: int        # per thread
    cluster: int          # blocks a row spans (1 on the resident routes)
    segment: int          # positions of a row a block holds


def threads_per_row(k):
    """The least power of two of threads that holds a row of k positions at
    ``POSITIONS`` a thread."""
    tpr = 1
    while tpr * POSITIONS < k:
        tpr *= 2
    return tpr


def row_split(k):
    """(segments, positions each) of a row of k > ``RESIDENT_MAX``
    positions, one block a segment: as few segments as hold it, the row
    split evenly between them in whole threads' chunks (``csrc/row_scan.cuh``:
    cluster_shape_ok up to ``CLUSTER_REACH``, segment_shape_ok beyond)."""
    if k <= RESIDENT_MAX:
        raise ValueError(f"rows of {k} positions are not split")
    blocks = -(-k // RESIDENT_MAX)
    segment = -(-k // blocks)
    return blocks, -(-segment // POSITIONS) * POSITIONS


def row_plan(k):
    """The launch of a solve's rows of length k: ``resident`` up to
    ``RESIDENT_MAX`` positions, ``threads_per_row(k)`` threads a row and
    ``BLOCK_THREADS / threads_per_row`` rows a block; ``cluster`` up to
    ``CLUSTER_REACH`` and ``segmented`` beyond, a block a segment
    (``row_split``)."""
    if k < 1:
        raise ValueError(f"the solve needs rows of at least 1 position, got {k}")
    if k > RESIDENT_MAX:
        blocks, segment = row_split(k)
        return SolvePlan("cluster" if k <= CLUSTER_REACH else "segmented", BLOCK_THREADS, 1,
                         BLOCK_THREADS, POSITIONS, blocks, segment)
    tpr = threads_per_row(k)
    return SolvePlan("resident", tpr, BLOCK_THREADS // tpr, BLOCK_THREADS, POSITIONS, 1, k)


def segment_totals(segments, n, shared_pivots):
    """The floats of a segmented route's totals buffer for n rows of this
    many segments (``csrc/row_scan.cuh``: seg_totals): each segment's
    Moebius total (4 floats) of every row, or once for a shared band, then
    its elimination total (2) and substitution total (3) of every row."""
    return segments * (4 * (1 if shared_pivots else n) + 5 * n)


def fit_totals(segments, n):
    """The floats of K6/K7's segmented fit's totals buffer for n rows of
    this many segments (``csrc/masked_cubic.cu``: fit_spans): each
    segment's first and last observed positions (2) of every row, then a
    solve's totals with pivots per row (``segment_totals``)."""
    return 2 * segments * n + segment_totals(segments, n, False)
