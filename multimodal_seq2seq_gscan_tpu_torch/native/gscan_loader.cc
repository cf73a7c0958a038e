// gscan_loader: native high-throughput loader for gSCAN dataset.txt files.
//
// Single-pass streaming JSON scan over a memory-mapped dataset file: for every
// example it records (offset, length) of the command / derivation /
// target_commands strings and of the raw situation object, and rasterizes the
// dense [grid, grid, D+5] uint8 situation tensor directly — the layout of the
// port's gscan/encode.py and of the reference Grid.encode (minigrid.py:380-399).
//
// The Python side (data/native_loader.py of this package) binds via ctypes
// and materializes numpy views; strings are decoded lazily from the mapped
// file. It builds this file at first use (g++ -O3 -march=native -shared
// -fPIC -std=c++17) into build/torch_native/ at the root of the checkout.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct Example {
  uint64_t command_off = 0, command_len = 0;
  uint64_t derivation_off = 0, derivation_len = 0;
  uint64_t target_off = 0, target_len = 0;
  uint64_t situation_off = 0, situation_len = 0;
  int32_t agent_pos = -1;   // row * grid + col
  int32_t target_pos = -1;  // row * grid + col
  uint64_t grid_index = 0;  // index into the split's grid buffer
};

struct SplitData {
  std::vector<Example> examples;
  std::vector<uint8_t> grids;  // n * grid * grid * channels
};

struct Dataset {
  const char* data = nullptr;
  uint64_t size = 0;
  int fd = -1;
  int grid_size = 0;
  int channels = 0;
  std::string error;
  std::unordered_map<std::string, SplitData> splits;
};

class Parser {
 public:
  Parser(Dataset* ds) : ds_(ds), p_(ds->data), end_(ds->data + ds->size) {}

  bool Fail(const char* msg) {
    char buf[256];
    snprintf(buf, sizeof(buf), "%s at offset %llu", msg,
             (unsigned long long)(p_ - ds_->data));
    ds_->error = buf;
    return false;
  }

  // Bounds-safe one-byte lookahead: '\0' past the end of the mapping, so a
  // truncated file fails cleanly in whatever parse state it interrupts
  // instead of dereferencing past the map.
  char Peek() const { return p_ < end_ ? *p_ : '\0'; }

  void SkipWs() {
    while (p_ < end_ && (*p_ == ' ' || *p_ == '\n' || *p_ == '\t' ||
                         *p_ == '\r')) {
      ++p_;
    }
  }

  // Scans a string; returns [start, len) of its contents. No unescaping —
  // gSCAN command/derivation strings contain no escapes; if one shows up we
  // record the raw span (callers json-decode the situation spans anyway).
  bool ScanString(uint64_t* off, uint64_t* len) {
    if (Peek() != '"') return Fail("expected string");
    ++p_;
    const char* start = p_;
    while (p_ < end_) {
      if (*p_ == '\\') {
        p_ += 2;
        continue;
      }
      if (Peek() == '"') {
        *off = start - ds_->data;
        *len = p_ - start;
        ++p_;
        return true;
      }
      ++p_;
    }
    return Fail("unterminated string");
  }

  bool SkipValue() {
    SkipWs();
    switch (Peek()) {
      case '{': return SkipObject();
      case '[': return SkipArray();
      case '"': {
        uint64_t o, l;
        return ScanString(&o, &l);
      }
      default: {
        while (p_ < end_ && *p_ != ',' && *p_ != '}' && *p_ != ']' &&
               *p_ != ' ' && *p_ != '\n' && *p_ != '\t' && *p_ != '\r') {
          ++p_;
        }
        return true;
      }
    }
  }

  bool SkipObject() {
    if (Peek() != '{') return Fail("expected {");
    ++p_;
    SkipWs();
    if (Peek() == '}') { ++p_; return true; }
    while (true) {
      SkipWs();
      uint64_t o, l;
      if (!ScanString(&o, &l)) return false;
      SkipWs();
      if (Peek() != ':') return Fail("expected :");
      ++p_;
      if (!SkipValue()) return false;
      SkipWs();
      if (Peek() == ',') { ++p_; continue; }
      if (Peek() == '}') { ++p_; return true; }
      return Fail("expected , or } in object");
    }
  }

  bool SkipArray() {
    if (Peek() != '[') return Fail("expected [");
    ++p_;
    SkipWs();
    if (Peek() == ']') { ++p_; return true; }
    while (true) {
      if (!SkipValue()) return false;
      SkipWs();
      if (Peek() == ',') { ++p_; continue; }
      if (Peek() == ']') { ++p_; return true; }
      return Fail("expected , or ] in array");
    }
  }

  bool ParseInt(long* out) {
    SkipWs();
    if (p_ >= end_) return Fail("expected integer");
    // Copy into a terminated buffer: the mapping is not null-terminated, so
    // strtol on a number abutting EOF could read past the last page.
    char buf[32];
    size_t n = (size_t)(end_ - p_);
    if (n > sizeof(buf) - 1) n = sizeof(buf) - 1;
    memcpy(buf, p_, n);
    buf[n] = 0;
    char* next = nullptr;
    *out = strtol(buf, &next, 10);
    if (next == buf) return Fail("expected integer");
    p_ += (next - buf);
    return true;
  }

  // Parses an integer that may be quoted ("7" or 7).
  bool ParseMaybeQuotedInt(long* out) {
    SkipWs();
    if (Peek() == '"') {
      uint64_t o, l;
      if (!ScanString(&o, &l)) return false;
      *out = strtol(ds_->data + o, nullptr, 10);
      return true;
    }
    return ParseInt(out);
  }

  // -- Top level ------------------------------------------------------------

  bool ParseTop() {
    SkipWs();
    if (Peek() != '{') return Fail("expected top-level object");
    ++p_;
    while (true) {
      SkipWs();
      uint64_t ko, kl;
      if (!ScanString(&ko, &kl)) return false;
      SkipWs();
      if (Peek() != ':') return Fail("expected :");
      ++p_;
      std::string key(ds_->data + ko, kl);
      if (key == "grid_size") {
        long v;
        if (!ParseInt(&v)) return false;
        ds_->grid_size = (int)v;
      } else if (key == "examples") {
        if (!ParseExamples()) return false;
      } else {
        if (!SkipValue()) return false;
      }
      SkipWs();
      if (Peek() == ',') { ++p_; continue; }
      if (Peek() == '}') return true;
      return Fail("expected , or } at top level");
    }
  }

  bool ParseExamples() {
    SkipWs();
    if (Peek() != '{') return Fail("expected examples object");
    ++p_;
    SkipWs();
    if (Peek() == '}') { ++p_; return true; }
    while (true) {
      SkipWs();
      uint64_t ko, kl;
      if (!ScanString(&ko, &kl)) return false;
      std::string split(ds_->data + ko, kl);
      SkipWs();
      if (Peek() != ':') return Fail("expected :");
      ++p_;
      if (!ParseSplit(&ds_->splits[split])) return false;
      SkipWs();
      if (Peek() == ',') { ++p_; continue; }
      if (Peek() == '}') { ++p_; return true; }
      return Fail("expected , or } in examples");
    }
  }

  bool ParseSplit(SplitData* split) {
    SkipWs();
    if (Peek() != '[') return Fail("expected split array");
    ++p_;
    SkipWs();
    if (Peek() == ']') { ++p_; return true; }
    while (true) {
      Example ex;
      if (!ParseExample(split, &ex)) return false;
      split->examples.push_back(ex);
      SkipWs();
      if (Peek() == ',') { ++p_; continue; }
      if (Peek() == ']') { ++p_; return true; }
      return Fail("expected , or ] in split");
    }
  }

  bool ParseExample(SplitData* split, Example* ex) {
    SkipWs();
    if (Peek() != '{') return Fail("expected example object");
    ++p_;
    while (true) {
      SkipWs();
      uint64_t ko, kl;
      if (!ScanString(&ko, &kl)) return false;
      SkipWs();
      if (Peek() != ':') return Fail("expected :");
      ++p_;
      std::string key(ds_->data + ko, kl);
      if (key == "command") {
        SkipWs();
        if (!ScanString(&ex->command_off, &ex->command_len)) return false;
      } else if (key == "derivation") {
        SkipWs();
        if (!ScanString(&ex->derivation_off, &ex->derivation_len)) {
          return false;
        }
      } else if (key == "target_commands") {
        SkipWs();
        if (!ScanString(&ex->target_off, &ex->target_len)) return false;
      } else if (key == "situation") {
        SkipWs();
        const char* sit_start = p_;
        if (!ParseSituation(split, ex)) return false;
        ex->situation_off = sit_start - ds_->data;
        ex->situation_len = p_ - sit_start;
      } else {
        if (!SkipValue()) return false;
      }
      SkipWs();
      if (Peek() == ',') { ++p_; continue; }
      if (Peek() == '}') { ++p_; return true; }
      return Fail("expected , or } in example");
    }
  }

  struct PlacedObject {
    std::string vector;
    long row = 0, col = 0;
  };

  bool ParseSituation(SplitData* split, Example* ex) {
    SkipWs();
    if (Peek() != '{') return Fail("expected situation object");
    ++p_;
    long agent_row = -1, agent_col = -1, agent_dir = -1;
    long target_row = -1, target_col = -1;
    std::vector<PlacedObject> objects;
    while (true) {
      SkipWs();
      uint64_t ko, kl;
      if (!ScanString(&ko, &kl)) return false;
      SkipWs();
      if (Peek() != ':') return Fail("expected :");
      ++p_;
      std::string key(ds_->data + ko, kl);
      if (key == "agent_position") {
        if (!ParsePosition(&agent_row, &agent_col)) return false;
      } else if (key == "agent_direction") {
        if (!ParseMaybeQuotedInt(&agent_dir)) return false;
      } else if (key == "target_object") {
        SkipWs();
        if (end_ - p_ >= 4 && strncmp(p_, "null", 4) == 0) {
          p_ += 4;
        } else {
          PlacedObject target;
          if (!ParsePositionedObject(&target)) return false;
          target_row = target.row;
          target_col = target.col;
        }
      } else if (key == "placed_objects") {
        if (!ParsePlacedObjects(&objects)) return false;
      } else {
        if (!SkipValue()) return false;
      }
      SkipWs();
      if (Peek() == ',') { ++p_; continue; }
      if (Peek() == '}') { ++p_; break; }
      return Fail("expected , or } in situation");
    }
    // Rasterize the dense grid.
    if (ds_->channels == 0 && !objects.empty()) {
      ds_->channels = (int)objects[0].vector.size() + 5;
    }
    int g = ds_->grid_size;
    int c = ds_->channels;
    if (g <= 0 || c <= 5) return Fail("grid dimensions not established");
    ex->grid_index = split->grids.size();
    split->grids.resize(split->grids.size() + (size_t)g * g * c, 0);
    uint8_t* grid = split->grids.data() + ex->grid_index;
    int d = c - 5;
    for (const PlacedObject& obj : objects) {
      if ((int)obj.vector.size() != d) return Fail("object vector length");
      if (obj.row < 0 || obj.row >= g || obj.col < 0 || obj.col >= g) {
        return Fail("object position out of grid bounds");
      }
      uint8_t* cell = grid + ((size_t)obj.row * g + obj.col) * c;
      for (int i = 0; i < d; ++i) cell[i] = obj.vector[i] - '0';
    }
    if (agent_row >= 0) {
      if (agent_row >= g || agent_col < 0 || agent_col >= g) {
        return Fail("agent position out of grid bounds");
      }
      if (agent_dir < 0 || agent_dir >= 4) {
        return Fail("agent direction out of range");
      }
      uint8_t* cell = grid + ((size_t)agent_row * g + agent_col) * c;
      cell[d] = 1;
      cell[d + 1 + agent_dir] = 1;
      ex->agent_pos = (int32_t)(agent_row * g + agent_col);
    }
    if (target_row >= 0 && (target_row >= g || target_col < 0 ||
                            target_col >= g)) {
      return Fail("target position out of grid bounds");
    }
    if (target_row >= 0) {
      ex->target_pos = (int32_t)(target_row * g + target_col);
    }
    return true;
  }

  bool ParsePosition(long* row, long* col) {
    SkipWs();
    if (Peek() != '{') return Fail("expected position object");
    ++p_;
    while (true) {
      SkipWs();
      uint64_t ko, kl;
      if (!ScanString(&ko, &kl)) return false;
      SkipWs();
      if (Peek() != ':') return Fail("expected :");
      ++p_;
      std::string key(ds_->data + ko, kl);
      long value;
      if (!ParseMaybeQuotedInt(&value)) return false;
      if (key == "row") *row = value;
      else if (key == "column") *col = value;
      SkipWs();
      if (Peek() == ',') { ++p_; continue; }
      if (Peek() == '}') { ++p_; return true; }
      return Fail("expected , or } in position");
    }
  }

  bool ParsePositionedObject(PlacedObject* obj) {
    SkipWs();
    if (Peek() != '{') return Fail("expected positioned object");
    ++p_;
    while (true) {
      SkipWs();
      uint64_t ko, kl;
      if (!ScanString(&ko, &kl)) return false;
      SkipWs();
      if (Peek() != ':') return Fail("expected :");
      ++p_;
      std::string key(ds_->data + ko, kl);
      if (key == "vector") {
        SkipWs();
        uint64_t vo, vl;
        if (!ScanString(&vo, &vl)) return false;
        obj->vector.assign(ds_->data + vo, vl);
      } else if (key == "position") {
        if (!ParsePosition(&obj->row, &obj->col)) return false;
      } else {
        if (!SkipValue()) return false;
      }
      SkipWs();
      if (Peek() == ',') { ++p_; continue; }
      if (Peek() == '}') { ++p_; return true; }
      return Fail("expected , or } in positioned object");
    }
  }

  bool ParsePlacedObjects(std::vector<PlacedObject>* objects) {
    SkipWs();
    if (Peek() != '{') return Fail("expected placed_objects object");
    ++p_;
    SkipWs();
    if (Peek() == '}') { ++p_; return true; }
    while (true) {
      SkipWs();
      uint64_t ko, kl;
      if (!ScanString(&ko, &kl)) return false;  // the index key "0", "1", ...
      SkipWs();
      if (Peek() != ':') return Fail("expected :");
      ++p_;
      PlacedObject obj;
      if (!ParsePositionedObject(&obj)) return false;
      objects->push_back(obj);
      SkipWs();
      if (Peek() == ',') { ++p_; continue; }
      if (Peek() == '}') { ++p_; return true; }
      return Fail("expected , or } in placed_objects");
    }
  }

 private:
  Dataset* ds_;
  const char* p_;
  const char* end_;
};

}  // namespace

extern "C" {

void* gscan_open(const char* path) {
  Dataset* ds = new Dataset();
  ds->fd = open(path, O_RDONLY);
  if (ds->fd < 0) {
    ds->error = "cannot open file";
    return ds;
  }
  struct stat st;
  fstat(ds->fd, &st);
  ds->size = st.st_size;
  ds->data = (const char*)mmap(nullptr, ds->size, PROT_READ, MAP_PRIVATE,
                               ds->fd, 0);
  if (ds->data == MAP_FAILED) {
    ds->data = nullptr;
    ds->error = "mmap failed";
    return ds;
  }
  Parser parser(ds);
  if (!parser.ParseTop()) {
    // error recorded in ds->error
  }
  return ds;
}

const char* gscan_error(void* handle) {
  Dataset* ds = (Dataset*)handle;
  return ds->error.c_str();
}

int gscan_grid_size(void* handle) { return ((Dataset*)handle)->grid_size; }
int gscan_channels(void* handle) { return ((Dataset*)handle)->channels; }

int64_t gscan_split_size(void* handle, const char* split) {
  Dataset* ds = (Dataset*)handle;
  auto it = ds->splits.find(split);
  if (it == ds->splits.end()) return -1;
  return (int64_t)it->second.examples.size();
}

int gscan_list_splits(void* handle, char* buffer, int buffer_len) {
  Dataset* ds = (Dataset*)handle;
  std::string joined;
  for (const auto& kv : ds->splits) {
    if (!joined.empty()) joined += ",";
    joined += kv.first;
  }
  if ((int)joined.size() + 1 > buffer_len) return -1;
  memcpy(buffer, joined.c_str(), joined.size() + 1);
  return (int)joined.size();
}

// Fills caller-allocated buffers:
//   offsets: int64 [n, 8] (command off/len, derivation off/len, target
//            off/len, situation off/len)
//   positions: int32 [n, 2] (agent_pos, target_pos)
//   grids: uint8 [n, grid, grid, channels]
int gscan_fill_split(void* handle, const char* split, int64_t* offsets,
                     int32_t* positions, uint8_t* grids) {
  Dataset* ds = (Dataset*)handle;
  auto it = ds->splits.find(split);
  if (it == ds->splits.end()) return -1;
  const SplitData& sd = it->second;
  size_t cell = (size_t)ds->grid_size * ds->grid_size * ds->channels;
  for (size_t i = 0; i < sd.examples.size(); ++i) {
    const Example& ex = sd.examples[i];
    int64_t* row = offsets + i * 8;
    row[0] = (int64_t)ex.command_off;
    row[1] = (int64_t)ex.command_len;
    row[2] = (int64_t)ex.derivation_off;
    row[3] = (int64_t)ex.derivation_len;
    row[4] = (int64_t)ex.target_off;
    row[5] = (int64_t)ex.target_len;
    row[6] = (int64_t)ex.situation_off;
    row[7] = (int64_t)ex.situation_len;
    positions[i * 2] = ex.agent_pos;
    positions[i * 2 + 1] = ex.target_pos;
    memcpy(grids + i * cell, sd.grids.data() + ex.grid_index, cell);
  }
  return 0;
}

void gscan_close(void* handle) {
  Dataset* ds = (Dataset*)handle;
  if (ds->data) munmap((void*)ds->data, ds->size);
  if (ds->fd >= 0) close(ds->fd);
  delete ds;
}

}  // extern "C"
