// The PyTorch port's copy of native/carmen_tokenizer.cpp, built at first use
// by my_lidar_graph_slam_tpu_torch/io/carmen.py (load_old_laser_fast).
//
// Fast CARMEN log tokenizer: the native data-loader fast path.
//
// The reference parses logs with line-by-line istream extraction
// (carmen_reader.cpp:11-42); for multi-hundred-MB logs that is the ingest
// bottleneck. This tokenizer memory-maps nothing fancy — it reads the file
// once and parses old-format FLASER/RLASER records (the record family of
// the Radish logs) with strtod directly into packed arrays consumable by
// NumPy via ctypes. PARAM and other record families are left to the Python
// reader, which remains the semantics oracle.
//
// Exported C ABI:
//   carmen_scan_count(path, tag) -> number of records with the given tag
//   carmen_parse_old_laser(path, tag, max_beams, max_scans,
//                          ranges, laser_poses, robot_poses,
//                          timestamps, beam_counts) -> scans parsed
//     ranges:      float32 [max_scans * max_beams]
//     laser_poses: float64 [max_scans * 3]
//     robot_poses: float64 [max_scans * 3]
//     timestamps:  float64 [max_scans]
//     beam_counts: int32   [max_scans]

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

bool ReadFile(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(size_t(size));
  const bool ok = std::fread(&(*out)[0], 1, size_t(size), f) == size_t(size);
  std::fclose(f);
  return ok;
}

inline bool TagMatches(const char* line, const char* tag, size_t tag_len) {
  return std::strncmp(line, tag, tag_len) == 0 &&
         (line[tag_len] == ' ' || line[tag_len] == '\t');
}

}  // namespace

extern "C" int carmen_scan_count(const char* path, const char* tag) {
  std::string data;
  if (!ReadFile(path, &data)) return -1;
  const size_t tag_len = std::strlen(tag);
  int count = 0;
  size_t pos = 0;
  while (pos < data.size()) {
    size_t eol = data.find('\n', pos);
    if (eol == std::string::npos) eol = data.size();
    if (eol - pos > tag_len && TagMatches(&data[pos], tag, tag_len)) ++count;
    pos = eol + 1;
  }
  return count;
}

extern "C" int carmen_parse_old_laser(
    const char* path, const char* tag, int max_beams, int max_scans,
    float* ranges, double* laser_poses, double* robot_poses,
    double* timestamps, int32_t* beam_counts) {
  std::string data;
  if (!ReadFile(path, &data)) return -1;
  const size_t tag_len = std::strlen(tag);

  int scan_idx = 0;
  size_t pos = 0;
  while (pos < data.size() && scan_idx < max_scans) {
    size_t eol = data.find('\n', pos);
    if (eol == std::string::npos) eol = data.size();
    if (eol - pos > tag_len && TagMatches(&data[pos], tag, tag_len)) {
      char* cur = &data[pos + tag_len];
      char* line_end = &data[eol];
      const char saved = *line_end;
      *line_end = '\0';

      char* next = nullptr;
      const long n = std::strtol(cur, &next, 10);
      if (next != cur && n > 0) {
        cur = next;
        const int nkeep = int(n) < max_beams ? int(n) : max_beams;
        float* dst = ranges + size_t(scan_idx) * max_beams;
        int b = 0;
        bool ok = true;
        for (; b < n; ++b) {
          const double v = std::strtod(cur, &next);
          if (next == cur) {
            ok = false;
            break;
          }
          if (b < nkeep) dst[b] = float(v);
          cur = next;
        }
        if (ok) {
          double tail[7];  // laser pose (3), robot pose (3), timestamp
          int t = 0;
          for (; t < 6; ++t) {
            tail[t] = std::strtod(cur, &next);
            if (next == cur) break;
            cur = next;
          }
          // Timestamp follows the poses (carmen_reader.cpp:349-352).
          double ts = 0.0;
          if (t == 6) {
            ts = std::strtod(cur, &next);
            if (next == cur) ts = 0.0;
          }
          if (t == 6) {
            for (int k = 0; k < 3; ++k) {
              laser_poses[size_t(scan_idx) * 3 + k] = tail[k];
              robot_poses[size_t(scan_idx) * 3 + k] = tail[3 + k];
            }
            timestamps[scan_idx] = ts;
            beam_counts[scan_idx] = int32_t(n);
            ++scan_idx;
          }
        }
      }
      *line_end = saved;
    }
    pos = eol + 1;
  }
  return scan_idx;
}
