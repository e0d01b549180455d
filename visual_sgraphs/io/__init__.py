"""Dataset ingestion: synthetic renderer + TUM/EuRoC/KITTI readers.

Replaces the reference's ROS topic ingestion (src/ros_*.cc) and the
``orb_slam3/Examples`` dataset loaders with in-process readers
(SURVEY §5.8: in-process ingestion replaces TCPROS).
"""

from visual_sgraphs.io.synthetic import SyntheticScene  # noqa: F401
from visual_sgraphs.io import tum  # noqa: F401
