"""Datasets of the port (`metro_pose3d_tpu/data/`): the registry
(`datasets.get_dataset`), the readers of H36M, MPI-INF-3DHP, MPII and 3DPW,
and the synthetic dataset, drawn without cv2."""
