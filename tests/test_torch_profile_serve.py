"""The serving profile's helpers, on the CPU (the profile itself needs a
GPU)."""
import pytest

pytest.importorskip("torch")

from repro_torch.launch.profile_serve import port_kernels, union_us


def test_port_kernels_names_every_kernel_of_the_sources_and_no_other():
    pat = port_kernels()
    for key in (
            "void (anonymous namespace)::decode_attn_split_kernel<false>"
            "(float const*, unsigned char const*)",
            "(anonymous namespace)::decode_attn_merge_kernel(float const*)",
            "(anonymous namespace)::row_sumsq_kernel(float const*, float*)",
            "void (anonymous namespace)::luq_matmul_kernel<true, 4>(float)"):
        assert pat.search(key), key
    for key in (
            "void (anonymous namespace)::softmax_warp_forward<float, 7>(float)",
            "void at::native::vectorized_elementwise_kernel<4, at::native::"
            "(anonymous namespace)::pow_tensor_scalar_kernel>(int)",
            "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN"):
        assert not pat.search(key), key


def test_union_us_counts_overlaps_once_and_clips_to_the_span():
    assert union_us([(0, 10), (5, 15), (20, 30)], 0, 100) == 25
    assert union_us([(-5, 5), (95, 105)], 0, 100) == 10
    assert union_us([], 0, 100) == 0
