"""The native perception host: a C++ daemon over the /dev/shm frame ring
(``src/perception_host.cpp``), its frame-ring producer (``src/ring_tool.cpp``)
and two executors, the embedded-Python one over ``runtime/embed.py
make_executor`` and the CUDA-graph one over ``make_graph_executor``.
``build.py`` compiles them with ``g++``; ``capi.py`` binds the C ABI that
the tests and ``chip_smoke.py`` call."""
