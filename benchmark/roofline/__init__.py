"""Work counts of the port's kernels and the card's published peaks.

One file a kernel, ``<kernel>.py``, names the port's entry point it
counts (``ENTRY``, an attribute of ``buildingsegment_tpu_torch.kernels``)
and gives ``work(args, kw, out) -> (bytes, f32 ops)``: each input byte
read once and each output byte written once, and the operations these
inputs need, from the call's inputs alone.  The counts are copied from
``chip_smoke.py``'s ``work()`` at commit e8749d5.
"""
