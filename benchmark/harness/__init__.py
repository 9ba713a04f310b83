"""The benchmark harness of orb_slam_system_tpu_torch (see benchmark/README.md)."""
