"""octree_regions_per_ray: the octree walk's region steps a ray walked:
the program's counters octree.regions over octree.rays (the rays the walk
took: every primary ray and each admitted shadow ray), over the frames of
the spans window's pass (a) (vrbench/spans.py).  Nothing without those
counters."""
from vrbench import spans


def read(run):
    s = spans.of(run)
    if s is None or not s.counters.get("octree.rays"):
        return None
    return s.counters.get("octree.regions", 0) / s.counters["octree.rays"]
