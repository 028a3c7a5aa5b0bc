// Native checkpoint bundle IO.
//
// Reference analog: save_op.cc / save_combine_op.cc — the C++ runtime
// streams each persistable tensor to disk in a framed binary format
// (SerializeToStream, framework/lod_tensor.cc). This is the port's copy of
// the JAX package's writer (both read and write this format): a
// single-file bundle of named raw tensors written with buffered stdio off
// the Python thread, committed durably (fflush+fsync+rename happens on the
// caller's temp→final path protocol).
//
// Format (little-endian):
//   magic  "PTCK1\n"
//   repeat per tensor:
//     u32 name_len, bytes name
//     u32 dtype_len, bytes dtype (numpy dtype str, e.g. "float32")
//     u32 ndim, i64 dims[ndim]
//     u64 nbytes, raw data
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <unistd.h>

namespace {

constexpr char kMagic[] = "PTCK1\n";

struct Writer {
  FILE* f = nullptr;
};

struct Entry {
  std::string name;
  std::string dtype;
  std::vector<int64_t> dims;
  uint64_t nbytes = 0;
  long offset = 0;  // file offset of the raw data
};

struct Reader {
  FILE* f = nullptr;
  std::vector<Entry> entries;
};

bool write_all(FILE* f, const void* p, size_t n) {
  return fwrite(p, 1, n, f) == n;
}

bool read_all(FILE* f, void* p, size_t n) {
  return fread(p, 1, n, f) == n;
}

}  // namespace

extern "C" {

void* ptck_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  if (!write_all(f, kMagic, sizeof(kMagic) - 1)) {
    fclose(f);
    return nullptr;
  }
  auto* w = new Writer();
  w->f = f;
  return w;
}

int ptck_write_tensor(void* handle, const char* name, const char* dtype,
                      int ndim, const int64_t* dims, const void* data,
                      uint64_t nbytes) {
  auto* w = static_cast<Writer*>(handle);
  if (!w || !w->f) return -1;
  uint32_t name_len = static_cast<uint32_t>(strlen(name));
  uint32_t dtype_len = static_cast<uint32_t>(strlen(dtype));
  uint32_t nd = static_cast<uint32_t>(ndim);
  if (!write_all(w->f, &name_len, 4) || !write_all(w->f, name, name_len) ||
      !write_all(w->f, &dtype_len, 4) || !write_all(w->f, dtype, dtype_len) ||
      !write_all(w->f, &nd, 4) ||
      (ndim > 0 && !write_all(w->f, dims, sizeof(int64_t) * ndim)) ||
      !write_all(w->f, &nbytes, 8) ||
      (nbytes > 0 && !write_all(w->f, data, nbytes))) {
    return -1;
  }
  return 0;
}

// flush + fsync; rename-to-final stays with the Python caller so the
// temp→durable protocol is shared with the pickle fallback
int ptck_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (!w) return -1;
  int rc = 0;
  if (w->f) {
    if (fflush(w->f) != 0) rc = -1;
    if (fsync(fileno(w->f)) != 0) rc = -1;
    if (fclose(w->f) != 0) rc = -1;
  }
  delete w;
  return rc;
}

void* ptck_read_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char magic[sizeof(kMagic)] = {0};
  if (!read_all(f, magic, sizeof(kMagic) - 1) ||
      memcmp(magic, kMagic, sizeof(kMagic) - 1) != 0) {
    fclose(f);
    return nullptr;
  }
  auto* r = new Reader();
  r->f = f;
  while (true) {
    uint32_t name_len = 0;
    if (fread(&name_len, 1, 4, f) != 4) break;  // clean EOF
    Entry e;
    e.name.resize(name_len);
    uint32_t dtype_len = 0, nd = 0;
    if (!read_all(f, e.name.data(), name_len) ||
        !read_all(f, &dtype_len, 4)) {
      goto corrupt;
    }
    e.dtype.resize(dtype_len);
    if (!read_all(f, e.dtype.data(), dtype_len) || !read_all(f, &nd, 4)) {
      goto corrupt;
    }
    e.dims.resize(nd);
    if (nd > 0 && !read_all(f, e.dims.data(), sizeof(int64_t) * nd)) {
      goto corrupt;
    }
    if (!read_all(f, &e.nbytes, 8)) goto corrupt;
    e.offset = ftell(f);
    if (fseek(f, static_cast<long>(e.nbytes), SEEK_CUR) != 0) goto corrupt;
    r->entries.push_back(std::move(e));
  }
  return r;
corrupt:
  fclose(f);
  delete r;
  return nullptr;
}

int64_t ptck_count(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  return r ? static_cast<int64_t>(r->entries.size()) : -1;
}

// meta query: copies name/dtype into caller buffers, returns nbytes
int64_t ptck_entry_meta(void* handle, int64_t i, char* name_buf,
                        int name_cap, char* dtype_buf, int dtype_cap,
                        int64_t* dims_buf, int dims_cap, int* ndim_out) {
  auto* r = static_cast<Reader*>(handle);
  if (!r || i < 0 || i >= static_cast<int64_t>(r->entries.size())) return -1;
  const Entry& e = r->entries[i];
  if (static_cast<int>(e.name.size()) + 1 > name_cap ||
      static_cast<int>(e.dtype.size()) + 1 > dtype_cap ||
      static_cast<int>(e.dims.size()) > dims_cap) {
    return -1;
  }
  snprintf(name_buf, name_cap, "%s", e.name.c_str());
  snprintf(dtype_buf, dtype_cap, "%s", e.dtype.c_str());
  for (size_t d = 0; d < e.dims.size(); ++d) dims_buf[d] = e.dims[d];
  *ndim_out = static_cast<int>(e.dims.size());
  return static_cast<int64_t>(e.nbytes);
}

int ptck_entry_data(void* handle, int64_t i, void* out, uint64_t cap) {
  auto* r = static_cast<Reader*>(handle);
  if (!r || i < 0 || i >= static_cast<int64_t>(r->entries.size())) return -1;
  const Entry& e = r->entries[i];
  if (cap < e.nbytes) return -1;
  if (fseek(r->f, e.offset, SEEK_SET) != 0) return -1;
  if (e.nbytes > 0 && !read_all(r->f, out, e.nbytes)) return -1;
  return 0;
}

void ptck_read_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (r) {
    if (r->f) fclose(r->f);
    delete r;
  }
}

}  // extern "C"
