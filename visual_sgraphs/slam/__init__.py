"""SLAM core: functional map state, tracking frontend, local mapping.

JAX rework of the reference's L3/L4 layers (Tracking.cc,
LocalMapping.cc, Atlas/Map/KeyFrame/MapPoint).  The map is an immutable
pytree of fixed-capacity arrays advanced by a single-writer update loop —
the mutex-guarded shared-state design of the reference (SURVEY §2.7)
disappears entirely.
"""

from visual_sgraphs.slam.map_state import MapState, empty_map  # noqa: F401
from visual_sgraphs.slam.frame import FrameObs, make_frame_obs  # noqa: F401
from visual_sgraphs.slam.system import SlamSystem, TrackState  # noqa: F401
