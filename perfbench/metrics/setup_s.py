"""setup_s: seconds from the process's start to the window's start
(imports, CUDA context, kernel builds or loads, weights and traffic from
the seed, books, warm-up and captures); host clock."""


def read(rec):
    return rec["setup_s"]
