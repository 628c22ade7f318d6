"""Datasets of the port (`metro_pose3d_tpu/data/`): the registry
(`datasets.get_dataset`) and the synthetic dataset, drawn without cv2."""
