from . import transforms
from .grid import GridSpec
from .maps import (
    FREE, UNKNOWN, FILLED, OccupancyComponentMap, OccupancyMap,
    SignedDistanceField, TaggedObjectOccupancyComponentMap,
    TaggedObjectOccupancyMap)
