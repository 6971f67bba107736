"""% of the images served in the traced window whose NMS kept exactly
``max_detections`` boxes (so lower-scored survivors were dropped)."""


def read(rec):
    c = rec['counters']
    return 100.0 * c['saturated_images'] / c['images'] if c.get('images') else None
