"""ORB feature pipeline: pyramid, FAST, oriented BRIEF, Hamming matching.

JAX replacement for the reference's ``ORBextractor``
(orb_slam3/src/ORBextractor.cc) and ``ORBmatcher``
(orb_slam3/src/ORBmatcher.cc).  Everything is batched over pixels /
keypoints / descriptor pairs; the sequential quadtree keypoint distribution
becomes a grid-cell top-K (behavioral parity, validated by match recall and
downstream ATE rather than bitwise identity — SURVEY.md §7.3).
"""

from visual_sgraphs.features.pyramid import build_pyramid, gaussian_blur  # noqa: F401
from visual_sgraphs.features.fast import fast_score  # noqa: F401
from visual_sgraphs.features.orb import (  # noqa: F401
    OrbParams,
    Keypoints,
    extract_orb,
)
from visual_sgraphs.features.match import (  # noqa: F401
    hamming_matrix,
    match_nn_ratio,
    match_window,
)
