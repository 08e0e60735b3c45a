"""The repo rules' linters for this package's tree: ``tmoglint`` (the
per-line TMG3xx rules) and ``concurrency_lint`` (the whole-program TMG8xx
rules), counterparts of the JAX package's ``tools/tmoglint.py`` and
``tools/concurrency_lint.py`` on this package's ``lint.Finding`` and
``lint.enforce``. ``python -m transmogrifai_tpu_torch lint`` runs both."""
