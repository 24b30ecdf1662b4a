"""DSEC-Det class names.

The reference nowhere declares names (num_classes: 8, config.yaml:30; its
committed sample overlays show pedestrian/car/bus). These are the DSEC-Det
label-set classes in Prophesee class_id order, used for overlay labels.
"""

DSEC_DET_CLASSES = [
    "pedestrian",
    "rider",
    "car",
    "bus",
    "truck",
    "bicycle",
    "motorcycle",
    "train",
]
