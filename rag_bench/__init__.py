"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): open-loop RAG
serving over a 1M x 1024 IVF corpus.  Run one cell once with
``python3 rag_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
