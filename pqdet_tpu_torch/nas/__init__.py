"""NAS search over RegNet-backbone detectors and hyper-parameter evolution
(the port of ``pqdet_tpu/nas/``)."""
