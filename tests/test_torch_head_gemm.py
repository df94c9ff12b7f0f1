"""The head GEMM's launch geometry and the C entry points, checked without a
card.

``csrc/taug_head.cu`` (K3 and K7) walks its output in units that
``ops/lvc_head.py:head_gemm_plan`` computes in Python and passes to the C
entry, which refuses a plan that differs from its own constants. These
tests hold the plan to its contract at every shape the port launches and at
ragged row counts, hold the Python constants to the source's, and hold
every ctypes signature in ``_build.SIGNATURES`` to the arity of its
``extern "C"`` definition (a mismatch would only show on the card).
"""

import re

import pytest

from fastdiff_tpu_torch.ops import _build, lvc_head

K = 192
N_TAUG = 4 * 64 * 104     # K3: layers * 2C * rows_p
N_AUG = 4 * 97 * 64       # K7: layers * (3C + 1) * 2C
SHAPES = ([(m, N_TAUG) for m in (864, 256, 100, 3456, 2000, 1, 131)]
          + [(m, N_AUG) for m in (864, 256, 1, 100, 131)])


def _source(name: str) -> str:
    return (_build.CSRC / name).read_text()


@pytest.mark.parametrize("m,n", SHAPES)
def test_plan_covers_every_tile_once(m, n):
    plan = lvc_head.head_gemm_plan(m, n, K)
    assert plan.m_tiles == -(-m // plan.tile_m)
    assert plan.n_tiles == -(-n // plan.tile_n)
    assert plan.units == plan.m_tiles * plan.n_tiles
    assert plan.grid == min(132, plan.units) == len(plan.ranges)
    tiles = []
    for begin, end in plan.ranges:
        for u in range(begin, end):
            nt, mt = divmod(u, plan.m_tiles)    # N-major walk
            tiles.append((mt, nt))
    assert sorted(tiles) == [(mt, nt) for mt in range(plan.m_tiles)
                             for nt in range(plan.n_tiles)]
    # contiguous runs, in block order
    assert plan.ranges[0][0] == 0 and plan.ranges[-1][1] == plan.units
    assert all(a[1] == b[0] for a, b in zip(plan.ranges, plan.ranges[1:]))
    runs = [end - begin for begin, end in plan.ranges]
    assert max(runs) - min(runs) <= 1 and min(runs) >= 1
    assert plan.smem_bytes <= lvc_head.SMEM_PER_BLOCK == 232_448
    assert plan.stages == 4 and plan.k_chunks == 3
    assert plan.c_args == (128, 128, plan.stages, plan.units, plan.grid,
                           plan.smem_bytes)


@pytest.mark.parametrize("m", [100, 256, 864, 2000])
@pytest.mark.parametrize("m_tile", [216, 432, 864])
@pytest.mark.parametrize("order", ["m_outer", "w_res"])
def test_walk_plan_covers_every_unit_once(order, m_tile, m):
    """K10's walks: every 128 x 128 unit once, in balanced contiguous runs;
    "w_res" is K3's N-major walk, "m_outer" stripes of ceil(m_tile / 128)
    M tiles, each walked across every N tile before the next stripe."""
    plan = lvc_head.head_gemm_walk_plan(m, N_TAUG, K, order, m_tile)
    k3 = lvc_head.head_gemm_plan(m, N_TAUG, K)
    assert plan.c_args == k3.c_args and plan.ranges == k3.ranges
    want = k3.m_tiles if order == "w_res" else min(k3.m_tiles,
                                                   -(-m_tile // 128))
    assert plan.stripe == want
    seen = [plan.unit_tile(u) for u in range(plan.units)]
    assert sorted(seen) == [(mt, nt) for mt in range(plan.m_tiles)
                            for nt in range(plan.n_tiles)]
    # stripe by stripe, and within one every M tile of an N tile together
    firsts = [mt // plan.stripe for mt, _ in seen]
    assert firsts == sorted(firsts)
    for u in range(1, plan.units):
        (m0, n0), (m1, n1) = seen[u - 1], seen[u]
        if m0 // plan.stripe == m1 // plan.stripe:
            assert (n1, m1) > (n0, m0)
    runs = [end - begin for begin, end in plan.ranges]
    assert max(runs) - min(runs) <= 1 and min(runs) >= 1
    assert sum(runs) == plan.units


@pytest.mark.parametrize("m", [100, 864, 2000])
@pytest.mark.parametrize("stripe_rows", [216, 432, 864])
def test_kernel_walk_matches_the_plan(stripe_rows, m):
    """``csrc/taug_head.cu``'s ``Walk`` (divisions at the start of a run,
    adds after) written out: every block's run reaches the plan's units,
    and its w_head tile changes (first unit, prefetch of the next tile,
    release after the last unit) fall where the N tile changes."""
    plan = lvc_head.head_gemm_walk_plan(m, N_TAUG, K, "m_outer", stripe_rows,
                                        sms=13)
    stripe, m_tiles, n_tiles = plan.stripe, plan.m_tiles, plan.n_tiles
    for begin, end in plan.ranges:
        per = stripe * n_tiles
        k, r = divmod(begin, per)
        rows = min(stripe, m_tiles - k * stripe)
        nt, mi = divmod(r, rows)
        loads = [nt]                      # load_b(0, w.nt)
        for u in range(begin, end):
            assert (k * stripe + mi, nt) == plan.unit_tile(u)
            first = u == begin or mi == 0
            assert first == (u == begin or plan.unit_tile(u - 1)[1] != nt)
            last = u + 1 == end or mi + 1 == rows
            assert last == (u + 1 == end or plan.unit_tile(u + 1)[1] != nt)
            if first and u + rows - mi < end:
                loads.append(nt + 1 if nt + 1 < n_tiles else 0)
            mi += 1                       # Walk.next
            if mi == rows:
                mi, nt = 0, nt + 1
                if nt == n_tiles:
                    nt, k = 0, k + 1
                    rows = min(stripe, m_tiles - k * stripe)
        # one w_head load per run of units under one N tile, in order
        tiles = [plan.unit_tile(u)[1] for u in range(begin, end)]
        want = [t for i, t in enumerate(tiles) if i == 0 or t != tiles[i - 1]]
        assert loads == want


def test_n_major_walk_is_k3s():
    """The stripe walk at stripe = m_tiles is K3's: nt = u // m_tiles."""
    plan = lvc_head.head_gemm_plan(864, N_TAUG, K)
    assert plan.stripe == plan.m_tiles == 7
    assert all(plan.unit_tile(u) == (u % 7, u // 7)
               for u in range(plan.units))


@pytest.mark.parametrize("order,m_tile", [("sideways", 216),
                                          ("m_outer", 0)])
def test_walk_plan_refuses(order, m_tile):
    with pytest.raises(ValueError):
        lvc_head.head_gemm_walk_plan(864, N_TAUG, K, order, m_tile)


def test_variant_entry_takes_the_walk():
    """K10's entry takes K3's arguments and the walk's stripe before the
    stream, and its definition has as many parameters."""
    sig = _build.SIGNATURES["taug_head_variant_launch"]
    assert sig == _build.SIGNATURES["taug_head_launch"][:-1] + [
        _build._I, _build._P]
    assert _extern_c_arities()["taug_head_variant_launch"] == len(sig)
    src = _source("taug_head.cu")
    assert "wmma" not in src and "taug_head_variant_kernel" not in src


def test_plan_at_the_10s_shapes():
    """The numbers the source's header and PERF.md quote."""
    k3 = lvc_head.head_gemm_plan(864, N_TAUG, K)
    assert (k3.units, k3.grid, k3.stages, k3.smem_bytes) == (
        1456, 132, 4, 231_680)
    assert {e - b for b, e in k3.ranges} == {11, 12}
    k7 = lvc_head.head_gemm_plan(864, N_AUG, K)
    assert (k7.units, k7.grid) == (1358, 132)


@pytest.mark.parametrize("k,stages", [(8, 8), (64, 8), (128, 6), (192, 4),
                                      (256, 2)])
def test_plan_stages_fill_shared_memory(k, stages):
    plan = lvc_head.head_gemm_plan(256, N_TAUG, k)
    assert plan.stages == stages
    assert plan.smem_bytes <= lvc_head.SMEM_PER_BLOCK
    if stages < lvc_head.HEAD_MAX_STAGES:      # one more stage would not fit
        assert plan.smem_bytes + 128 * 64 * 2 > lvc_head.SMEM_PER_BLOCK


@pytest.mark.parametrize("m,n,k", [(864, N_TAUG, 264), (0, N_TAUG, K),
                                   (864, 0, K)])
def test_plan_refuses(m, n, k):
    with pytest.raises(ValueError):
        lvc_head.head_gemm_plan(m, n, k)


def test_plan_small_card():
    """Fewer SMs than units: still one run per block, balanced."""
    plan = lvc_head.head_gemm_plan(864, N_TAUG, K, sms=114)
    runs = [end - begin for begin, end in plan.ranges]
    assert plan.grid == 114 and sum(runs) == plan.units
    assert max(runs) - min(runs) <= 1


def test_python_geometry_matches_the_source():
    src = _source("taug_head.cu")

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("HM") == lvc_head.HEAD_TILE_M
    assert const("HN") == lvc_head.HEAD_TILE_N
    assert const("HK") == lvc_head.HEAD_CHUNK_K
    assert const("MAX_STAGES") == lvc_head.HEAD_MAX_STAGES
    assert const("MAX_KC") == lvc_head.HEAD_MAX_CHUNKS
    assert const("SMEM_LIMIT") == lvc_head.SMEM_PER_BLOCK
    assert re.search(r"constexpr int BIAS_BYTES = 2 \* HN \* 4;", src)
    assert const("SMEM_ALIGN") + const("BARRIER_BYTES") + 2 * const("HN") * 4 \
        == lvc_head._SMEM_SLACK


def _extern_c_arities() -> dict:
    """name -> parameter count of every ``extern "C"`` definition in
    ``csrc/*.cu``."""
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        src = path.read_text()
        for match in re.finditer(
                r'extern "C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)\s*\{', src):
            params = [p for p in match.group(2).split(",") if p.strip()]
            found[match.group(1)] = len(params)
    return found


def test_signatures_match_extern_c_definitions():
    arities = _extern_c_arities()
    assert "fastdiff_cuda_error_string" in arities
    for name, argtypes in _build.SIGNATURES.items():
        assert name in arities, f"{name} has no extern \"C\" definition"
        assert arities[name] == len(argtypes), name


def test_head_entries_take_the_plan():
    """K3 and K7 take M, N, K and the plan's six ints between the four
    pointers and the stream."""
    for name in ("taug_head_launch", "aug_head_launch"):
        sig = _build.SIGNATURES[name]
        assert sig[:4] == [_build._P] * 4 and sig[-1] is _build._P
        assert sig[4:-1] == [_build._I] * (3 + len(
            lvc_head.head_gemm_plan(864, N_TAUG, K).c_args))


def test_experiment_variants_apply():
    """``scripts/exp_head_gemm.py`` edits the kernel's source into its
    variants; the lines it removes are still there."""
    from fastdiff_tpu_torch.scripts import exp_head_gemm
    sources = exp_head_gemm.variant_sources()
    assert set(sources) == {"kernel", "no_store", "mma_only"}
    assert sources["kernel"] == _source("taug_head.cu")
    assert "tma_store(&map_out, tile," not in sources["no_store"]
    assert "st.shared.b32" not in sources["mma_only"]
    assert "mbar_arrive(empty_b + 8 * slot);" in sources["mma_only"]
