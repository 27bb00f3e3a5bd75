// Bounds checks on global stores, compiled in only for a checked build.
//
// PPT_CHECK(i, n) guards a store to element i of an output with n
// elements.  n is the output's allocated size: the host wrapper passes
// each guarded output's numel down through its C entry point, and a
// kernel takes it as a trailing PPT_EXTENT(name) parameter that a launch
// fills with PPT_ARG(value).  An extent is never the grid or loop bound
// that produced the index, so a launch geometry that is wrong against
// the buffer fires the check.  The normal build expands all three to
// nothing: its kernels keep their parameters and object code.  Built
// with -DPPT_CHECKED (csrc/_build.py under PPTORCH_KERNEL_CHECKS=1, into
// a library of its own), an index outside [0, n) stops the kernel with
// __trap(): the launch's stream then reports an error instead of a
// silently overwritten neighbour.
#pragma once

#ifdef PPT_CHECKED
#define PPT_CHECK(i, n)                                                    \
  do {                                                                     \
    if ((long long)(i) < 0 || (long long)(i) >= (long long)(n)) __trap();  \
  } while (0)
#define PPT_EXTENT(name) , long long name
#define PPT_ARG(value) , (long long)(value)
#else
#define PPT_CHECK(i, n) ((void)0)
#define PPT_EXTENT(name)
#define PPT_ARG(value)
#endif
