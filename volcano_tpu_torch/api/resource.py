"""Resource tolerance floors (reference: pkg/scheduler/api/resource_info.go:70-72).

Quantities below these are treated as zero by IsEmpty/IsZero and as
equal by LessEqual; the packed session carries them as the per-lane
``tolerance`` vector.  A copy of the constants in
``volcano_tpu/api/resource.py``.
"""

MIN_MILLI_CPU = 10.0
MIN_MILLI_SCALAR = 10.0
MIN_MEMORY = 10.0 * 1024 * 1024
