// Python bindings of the kernels' C entry points, without ctypes.
//
// Every kernel source keeps its plain C entry points, each
//   extern "C" int fn(arguments..., void* stream)
// returning the first cudaError_t it saw, and exports them again as the
// functions of a small CPython extension module named after the source:
//
//   PYENTRY_MODULE(searchsorted, PYENTRY_FN(searchsorted_launch))
//
// defines PyInit_searchsorted, whose module has one function,
// searchsorted_launch.  A function takes its arguments as a vector call
// (METH_FASTCALL: no tuple, no keyword parsing), converts each by the C++ type
// of the entry point's parameter, keeps the GIL, calls the entry point and
// returns its int.  The conversions:
//   a pointer (any T*, the stream too)  PyLong_AsVoidPtr: all 64 bits;
//   int                                 PyLong_AsLong, then OverflowError
//                                       outside [INT_MIN, INT_MAX];
//   float                               PyFloat_AsDouble (a float or an int).
// A wrong argument count raises TypeError; a parameter of any other type does
// not compile.
//
// Header only, and it needs no CUDA: repro_torch/kernels/_build.py compiles
// each kernel source with nvcc and -I for Python.h and imports the result;
// tests/test_torch_pyentry.py compiles it with g++ around a host function.
#pragma once

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <climits>
#include <cstddef>
#include <tuple>
#include <utility>

namespace pyentry {

// Converts one Python argument to T; false with a Python error set on failure.
template <class T>
struct Arg;

template <class T>
struct Arg<T*> {
  static bool get(PyObject* o, T*& out) {
    void* p = PyLong_AsVoidPtr(o);
    if (p == nullptr && PyErr_Occurred()) return false;
    out = static_cast<T*>(p);
    return true;
  }
};

template <>
struct Arg<int> {
  static bool get(PyObject* o, int& out) {
    const long v = PyLong_AsLong(o);
    if (v == -1 && PyErr_Occurred()) return false;
    if (v < INT_MIN || v > INT_MAX) {
      PyErr_Format(PyExc_OverflowError, "%ld does not fit a C int", v);
      return false;
    }
    out = static_cast<int>(v);
    return true;
  }
};

template <>
struct Arg<float> {
  static bool get(PyObject* o, float& out) {
    const double v = PyFloat_AsDouble(o);
    if (v == -1.0 && PyErr_Occurred()) return false;
    out = static_cast<float>(v);
    return true;
  }
};

template <class... A, std::size_t... I>
PyObject* call(int (*fn)(A...), PyObject* const* args, std::index_sequence<I...>) {
  std::tuple<A...> v;
  // left to right, stopping at the first argument that does not convert
  if (!(Arg<A>::get(args[I], std::get<I>(v)) && ...)) return nullptr;
  return PyLong_FromLong(fn(std::get<I>(v)...));
}

// Calls fn on the n arguments of a vector call; returns its int, or nullptr
// with a Python error set.
template <class... A>
PyObject* fastcall(int (*fn)(A...), PyObject* const* args, Py_ssize_t n) {
  if (n != static_cast<Py_ssize_t>(sizeof...(A))) {
    PyErr_Format(PyExc_TypeError, "takes %zd arguments (%zd given)",
                 static_cast<Py_ssize_t>(sizeof...(A)), n);
    return nullptr;
  }
  return call(fn, args, std::index_sequence_for<A...>{});
}

template <auto Fn>
PyObject* method(PyObject*, PyObject* const* args, Py_ssize_t n) {
  return fastcall(Fn, args, n);
}

}  // namespace pyentry

// One method-table entry: the C entry point fn as the module function "fn".
#define PYENTRY_FN(fn)                                                          \
  PyMethodDef {                                                                 \
    #fn,                                                                        \
        reinterpret_cast<PyCFunction>(                                          \
            reinterpret_cast<void (*)(void)>(&pyentry::method<fn>)),            \
        METH_FASTCALL, nullptr                                                  \
  }

// The module `name` (PyInit_name) with the functions listed (PYENTRY_FN each).
#define PYENTRY_MODULE(name, ...)                                               \
  static PyMethodDef pyentry_methods_[] = {                                     \
      __VA_ARGS__, PyMethodDef{nullptr, nullptr, 0, nullptr}};                  \
  static PyModuleDef pyentry_module_ = {                                        \
      PyModuleDef_HEAD_INIT, #name, nullptr, -1, pyentry_methods_,              \
      nullptr, nullptr, nullptr, nullptr};                                      \
  PyMODINIT_FUNC PyInit_##name() { return PyModule_Create(&pyentry_module_); }
