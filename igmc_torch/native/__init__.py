"""The C++ extraction engine's source (extract.cpp) and its build (build.py);
graphs/native.py binds it."""
