"""orb_slam_system_tpu_torch — the PyTorch + CUDA port of orb_slam_system_tpu.

The JAX package beside this one is the reference; this package mirrors its
layout (ops/, solvers/, models/, utils/, dataio/) so the counterpart of each
module is easy to find. It imports torch and never jax. Every Pallas kernel
on the ported path is a hand-written CUDA kernel for Hopper (sm_90a) under
csrc/, built at first use by utils/kernels.py; each kernel's plain PyTorch
version lives beside its wrapper and serves CPU tensors.

Ported so far: the monocular, stereo and RGB-D System (models/system.py):
the front end (FrameBuilder.build, build_stereo, build_rgbd), two-view or
depth initialization, the fused steady-state tracking step with its
fallbacks, local mapping inline or on its worker thread, place
recognition with relocalization (vocab/, mapping/keyframe_db.py,
models/place_recognition.py, solvers/pnp.py), loop closing with global BA
(models/loop_closing.py), localization mode, and the realtime modes: the
streaming mode and the pipelined device-state chain step
(TrackPrograms.chain_step). Sequences and maps from disk: the dataset
readers (dataio/datasets.py) over the native PNG/PNM decoder (native/,
C++ built with g++ at first use), the TUM, KITTI and EuRoC drivers with
drivers/run_dataset.py, and map save/load (mapping/serialize.py,
System.save_map / load_map). The multi-sequence mode (parallel/), the long
runs, the viewer and the AR overlay. The ROS bridge and its four nodes
(dataio/ros_bridge.py, drivers/ros_*.py), the live-camera and video
drivers, the warm pass (utils/warmup.py, System(prewarm=True)), and the
sharded solvers over torch.distributed (parallel/ba_dist.py,
parallel/pose_graph_dist.py, the dp x sp front-end step and its dry run):
with them the port does everything the JAX package does.
"""

__version__ = "0.1.0"
