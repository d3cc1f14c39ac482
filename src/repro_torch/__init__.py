"""HedraRAG serving stack in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (``sm_90a``).

The package mirrors ``repro``'s sub-package layout so each module's
counterpart is easy to find.  It imports ``torch`` and numpy only.  Its entry
points (``GenerationEngine``, ``HybridRetrievalEngine``, ``IVFIndex.build``,
``models.lm.init_params`` and ``launch.serve``) run on the card unless the
caller passes ``device="cpu"``.
"""
