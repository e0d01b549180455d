"""Hierarchical scene graph: planes, semantic voting, rooms, doors, markers.

The vS-Graphs layer (SURVEY §2.3: GeometricSegmentation,
SemanticSegmentation, SemanticsManager, GeoSemHelpers + the Plane/Room/Door/
Marker map entities) rebuilt as batched arrays: point clouds are fixed-size arrays,
RANSAC is a batched hypotheses×points contraction, association is a dense
plane-table reduction, and the external segmenter/voxblox processes become
pluggable per-pixel class inputs (dataset-provided or model-provided).
"""

from visual_sgraphs.scenegraph.pointcloud import (  # noqa: F401
    backproject_depth,
    voxel_downsample,
)
from visual_sgraphs.scenegraph.plane_fit import (  # noqa: F401
    ransac_plane,
    extract_planes,
)
from visual_sgraphs.scenegraph.state import (  # noqa: F401
    SceneGraphState,
    empty_scenegraph,
)
from visual_sgraphs.scenegraph.manager import SceneGraphManager  # noqa: F401

GROUND, WALL, CEILING, UNDEFINED = 0, 1, 2, -1
