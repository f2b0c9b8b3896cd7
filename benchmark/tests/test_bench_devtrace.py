"""The device trace's reduction: busy time as a union, idle gaps named by
what the host was doing."""

import benchtools  # noqa: F401  (puts the benchmark on sys.path)

import devtrace


def test_union_counts_overlap_once_and_clips_to_the_window():
    events = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 95, 120)]
    out = devtrace.summarize(events, [], 0, 100)
    assert out["busy_s"] == 30e-9  # [0, 15) + [20, 30) + [95, 100)
    assert out["window_s"] == 100e-9
    assert out["kernels"]["a"] == {"launches": 1, "seconds": 10e-9}


def test_gaps_are_named_by_the_host_span_they_overlap_most():
    events = [("k", 10, 20), ("k", 60, 70)]
    spans = [("tracegen", 1, 50), ("prove", 50, 100)]
    out = devtrace.summarize(events, spans, 0, 100)
    assert out["idle_gaps"] == [["tracegen", 40e-9], ["prove", 30e-9], ["tracegen", 10e-9]]
    assert out["device_ops"] == [["k", 20e-9]]


def test_hand_kernel_launches_by_wrapper():
    kernels = {"ntt_pass_kernel": {"launches": 13, "seconds": 1.0},
               "poseidon_grind_kernel": {"launches": 1, "seconds": 0.1},
               "poseidon_sponge_kernel": {"launches": 40, "seconds": 0.1}}
    assert devtrace.hand_launches(kernels) == {"ntt": 13, "keccak": 0, "poseidon": 41}


def test_kernel_names_drop_templates_and_arguments():
    assert devtrace.kernel_name("void ntt_pass_kernel<4>(long*, int)") == "ntt_pass_kernel"
