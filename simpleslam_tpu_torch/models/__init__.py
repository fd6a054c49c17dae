"""Stateful SLAM components wiring the device ops into the pipeline
(frontend, registration, map manager, lidar odometry)."""
