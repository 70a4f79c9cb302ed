from .topology import DataNode, Topology, VolumeLayout
from .volume_growth import VolumeGrowth

__all__ = ["DataNode", "Topology", "VolumeLayout", "VolumeGrowth"]
