"""moe.gemm_roofline.device_paced: the routed experts' grouped GEMMs'
share of their roofline: the sum of each call's bound (operations tokens x
top_k x 3 x 2 x dim x inner and its bytes, from the ``dvd.dit.moe``
span's attributes, bounded as ``perfbench/arith.py`` bounds K1 and K2)
over the device time launched inside ``dvd.dit.moe.experts``, whatever
implements the products (``perfbench/moe_spans.py``).  None where the
program records no such span."""

from perfbench import moe_spans


def read(rec):
    return moe_spans.gemm_roofline(rec)
