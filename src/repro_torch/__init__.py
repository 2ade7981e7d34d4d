"""Hercules on PyTorch + CUDA (NVIDIA Hopper).

A second implementation of the Hercules exact-kNN index beside the JAX
package ``repro``, with the same relative module paths so each port file
sits where its reference does. The package imports ``torch``, ``numpy``
and the standard library only.

Entry points (:func:`repro_torch.core.engine.make_backend`,
:meth:`repro_torch.core.index.HerculesIndex.build`,
:func:`repro_torch.data.synthetic.random_walks`, the search CLI) run on the
CUDA device unless the caller passes ``device="cpu"``; with no CUDA device
they raise instead of falling back.
"""
