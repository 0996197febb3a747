"""Image and descriptor operations and their hand-written CUDA kernels:
pyramid, FAST/Harris, ORB and SIFT description, descriptor matching (port
of rpe_tpu.ops; the kernels are built at their first launch). The names are
the reference's; its fused matchers are the port's kernel-backed ones,
`match_hamming` (cross-check) and `match_ratio` (Lowe ratio test)."""

from .fast import fast_score_map, harris_response_map, nonmax_suppress_3x3
from .match import cross_check_match, hamming_distance_matrix, \
    l2sq_distance_matrix, ratio_test_match, unpack_descriptor_bits
from .match import match_hamming as cross_check_match_fused
from .match import match_ratio as ratio_match_fused
from .orb import orb_detect_and_describe
from .pyramid import build_pyramid, gaussian_blur, level_shapes

__all__ = [
    "cross_check_match",
    "hamming_distance_matrix",
    "l2sq_distance_matrix",
    "ratio_test_match",
    "unpack_descriptor_bits",
    "cross_check_match_fused",
    "ratio_match_fused",
    "orb_detect_and_describe",
    "build_pyramid",
    "gaussian_blur",
    "level_shapes",
    "fast_score_map",
    "harris_response_map",
    "nonmax_suppress_3x3",
]
