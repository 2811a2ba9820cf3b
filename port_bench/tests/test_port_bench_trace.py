"""The reduction of a profiler session, on hand-made events."""

from port_bench import trace


def test_union_merges_overlaps():
    assert trace._union([(2, 3), (0, 1), (0.5, 1.5), (3, 4)]) == [(0, 1.5), (2, 4)]


def test_idle_gaps_are_named_by_the_innermost_open_operator():
    busy = [(0, 1), (2, 3), (5, 6), (7, 8)]
    host = [((0.5, 4.5), "outer"), ((0.8, 1.2), "inner"), ((6.5, 6.8), "done")]
    assert trace._idle_gaps(busy, host) == {"inner": 1, "outer": 2, "(host between operators)": 1}


def test_families_and_breakdown():
    assert trace.family("void said::flash_attention_kernel<float>") == trace.ATTENTION_FAMILY
    assert trace.family("sm90_xmma_gemm_f32f32") == "cuBLAS GEMM/GEMV"
    assert trace.family("vectorized_elementwise_kernel") == "elementwise/other"
    fams = {f"f{i}": float(i) for i in range(12)}
    b = trace.breakdown({"by_family_s": fams, "idle_gaps": {"x": 0.5}})
    assert b["device_ops"][0] == ["f11", 11.0] and len(b["device_ops"]) == 10
    assert b["idle_gaps"] == [["x", 0.5]]
