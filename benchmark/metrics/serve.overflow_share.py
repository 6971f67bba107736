"""% of the images served in the traced window whose NMS candidate pool
overflowed: more (box, class) pairs above the score threshold than
``max_detections * pool_factor``, the rest never entering NMS."""


def read(rec):
    c = rec['counters']
    return 100.0 * c['overflow_images'] / c['images'] if c.get('images') else None
