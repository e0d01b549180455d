"""Place recognition: BoW vocabulary/database, Sim3 RANSAC, essential-graph
pose-graph optimization, loop closing and relocalization.

JAX rebuild of the reference's DBoW2 + KeyFrameDatabase + Sim3Solver +
OptimizeEssentialGraph + LoopClosing stack (SURVEY §2.3/§2.5/§2.6).
"""

from visual_sgraphs.place.database import (
    PlaceDB,
    add_keyframe,
    detect_candidates,
    empty_db,
    l1_scores,
)
from visual_sgraphs.place.loop_closer import LoopCloser
from visual_sgraphs.place.pgo import (
    build_covis_edges,
    correct_map,
    optimize_essential_graph,
)
from visual_sgraphs.place.sim3_ransac import ransac_sim3
from visual_sgraphs.place.vocab import (
    VocabTree,
    bow_vector,
    descend,
    fit_vocab,
    load_vocab,
    save_vocab,
)

__all__ = [
    "PlaceDB",
    "add_keyframe",
    "detect_candidates",
    "empty_db",
    "l1_scores",
    "LoopCloser",
    "build_covis_edges",
    "correct_map",
    "optimize_essential_graph",
    "ransac_sim3",
    "VocabTree",
    "bow_vector",
    "descend",
    "fit_vocab",
    "load_vocab",
    "save_vocab",
]
