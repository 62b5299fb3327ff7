// The facet splitter's minimum-|flux| divider search, host C++.
//
// Port of the divider search behind radler_tpu/parallel/dijkstra.py
// (DijkstraSplitter.divide_vertically; the reference's
// cpp/math/dijkstra_splitter.cc:34-86).  Dijkstra's search over the pixels
// of columns [x1, x2): a path starts anywhere on row 0, steps down, down
// left, down right, left or right, and costs the sum of |image| over its
// pixels; the cheapest path to the bottom row is marked with 1.0.
//
// Ties are common (zero pixels) and the path a tie picks decides the
// facets' boxes, so the visiting order is the reference's exactly: a
// std::priority_queue ordered on the distance alone, the moves pushed in
// the same order, and a pixel's distance set only by a strictly shorter
// visit.
//
// The flood of an area between dividers (dijkstra_splitter.cc:144-216)
// is here too: one pass along each row (or column) of the image.
//
// kernels/_build.py builds this file with the host's C++ compiler;
// parallel/dijkstra.py calls it through ctypes.

#include <cmath>
#include <limits>
#include <queue>
#include <vector>

namespace {

struct Visit {
  double distance;
  int to_x, to_y;
  int from_x, from_y;
  // std::priority_queue keeps its largest element on top: invert the order
  // so that the shortest visit comes first.
  bool operator<(const Visit& other) const {
    return distance > other.distance;
  }
};

}  // namespace

extern "C" {

// image and output are [height, width] float32; output's columns [x1, x2)
// are zeroed, then the path is written into them.
void radler_divide_vertically(const float* image, float* output, int width,
                              int height, int x1, int x2) {
  for (int y = 0; y < height; ++y) {
    float* row = output + static_cast<size_t>(y) * width;
    for (int x = x1; x < x2; ++x) row[x] = 0.0f;
  }
  const int span = x2 - x1;
  const size_t n = static_cast<size_t>(height) * span;
  std::vector<double> dist(n, std::numeric_limits<double>::infinity());
  std::vector<int> prev_x(n, -1);
  std::vector<int> prev_y(n, -1);

  std::priority_queue<Visit> visits;
  for (int x = x1; x < x2; ++x) visits.push(Visit{0.0, x, 0, x, 0});
  int end_x = x1, end_y = 0;
  while (!visits.empty()) {
    const Visit visit = visits.top();
    visits.pop();
    const int x = visit.to_x;
    const int y = visit.to_y;
    if (y == height) {
      end_x = visit.from_x;
      end_y = visit.from_y;
      break;
    }
    const size_t index = static_cast<size_t>(y) * span + (x - x1);
    const double distance =
        visit.distance + std::fabs(image[static_cast<size_t>(y) * width + x]);
    if (distance < dist[index]) {
      dist[index] = distance;
      prev_x[index] = visit.from_x;
      prev_y[index] = visit.from_y;
      if (x > x1) {
        visits.push(Visit{distance, x - 1, y + 1, x, y});
        visits.push(Visit{distance, x - 1, y, x, y});
      }
      visits.push(Visit{distance, x, y + 1, x, y});
      if (x < x2 - 1) {
        visits.push(Visit{distance, x + 1, y + 1, x, y});
        visits.push(Visit{distance, x + 1, y, x, y});
      }
    }
  }
  int px = end_x, py = end_y;
  while (py > 0) {
    output[static_cast<size_t>(py) * width + px] = 1.0f;
    const size_t index = static_cast<size_t>(py) * span + (px - x1);
    const int nx = prev_x[index];
    py = prev_y[index];
    px = nx;
  }
  output[px] = 1.0f;
}

// The area of a divided image that holds position `start` of each of its
// n_lines lines (rows, or columns) of n_positions pixels, element (line,
// position) at line * line_stride + position * position_stride of
// subdivision (non-zero on the dividers) and of mask (zeroed by the
// caller): from `start` back over free pixels, then over the divider's
// run, which belongs to the area, and on up to the next divider pixel.
// Sets *first to the area's least position and *end to one past its
// greatest.
void radler_flood_area(const float* subdivision, unsigned char* mask,
                       int n_lines, int n_positions, long long line_stride,
                       long long position_stride, int start, int* first,
                       int* end) {
  int least = n_positions, past = 0;
  for (int line = 0; line < n_lines; ++line) {
    const float* in = subdivision + line * line_stride;
    unsigned char* out = mask + line * line_stride;
    auto divider = [&](int p) { return in[p * position_stride] != 0.0f; };
    int p = start;
    while (p >= 0 && !divider(p)) --p;
    while (p >= 0 && divider(p)) --p;
    const int lo = p + 1;
    p = start + 1;
    while (p < n_positions && !divider(p)) ++p;
    for (int q = lo; q < p; ++q) out[q * position_stride] = 1;
    if (lo < least) least = lo;
    if (p > past) past = p;
  }
  *first = least;
  *end = past;
}

}  // extern "C"
