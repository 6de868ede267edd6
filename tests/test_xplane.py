"""tools/xplane_parse.py on a small GPU-shaped trace built in memory."""

from jax.profiler import ProfileData

from tools import xplane_parse

_TRACE = """
planes {
  id: 1 name: "/device:GPU:0"
  lines {
    id: 1 name: "Stream #13(Compute)" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 4000000 }
    events { metadata_id: 2 offset_ps: 6000000 duration_ps: 2000000 }
    events { metadata_id: 1 offset_ps: 9000000 duration_ps: 1000000 }
  }
  lines {
    id: 2 name: "Stream #14(Compute)" timestamp_ns: 1000
    events { metadata_id: 2 offset_ps: 3000000 duration_ps: 2000000 }
  }
  lines {
    id: 3 name: "XLA Ops" timestamp_ns: 1000
    events { metadata_id: 2 offset_ps: 0 duration_ps: 10000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "bvh_nearest_hit" } }
  event_metadata { key: 2 value { id: 2 name: "loop_fusion" } }
}
planes { id: 2 name: "/host:CPU" }
"""


def test_gpu_plane_kernel_times_and_idle_share():
    profile = ProfileData.from_serialized_xspace(
        ProfileData.text_proto_to_serialized_xspace(_TRACE)
    )
    [plane] = xplane_parse.gpu_planes(profile)
    s = xplane_parse.summarize(plane)
    # stream lines only: the derived "XLA Ops" line is not counted twice
    assert s["kernels"]["bvh_nearest_hit"] == [0.005, 2]
    assert s["kernels"]["loop_fusion"] == [0.004, 2]
    # busy = union of [0,4) [3,5) [6,8) [9,10) us = 8 us of a 10 us window
    assert abs(s["busy_ms"] - 0.008) < 1e-12
    assert abs(s["window_ms"] - 0.010) < 1e-12
    assert abs(s["idle"] - 0.2) < 1e-9
